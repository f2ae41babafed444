"""The port's whole chat slice against the JAX package on the CPU: the
multimodal forward of `__graft_entry__.entry()`, greedy token streams of
the Generator (plain and int4 weights), `VitronSystem.chat`, and a run with
JAX blocked from importing. Float32 tolerance rtol=atol=1e-4.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from vitron_tpu_torch.apps.cli import DemoTokenizer
from vitron_tpu_torch.models import vitron_model as tvm
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.llm.llama import LlamaConfig
from vitron_tpu_torch.models.vision.vit import ViTConfig
from vitron_tpu_torch.runtime import generation as tgen
from vitron_tpu_torch.runtime.engine import VitronEngine
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-4


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def test_entry_logits_match_jax():
    """The port's forward on entry()'s own inputs, with entry()'s params
    carried across, gives entry()'s logits. Float32 rounding alone leaves
    both packages ~1e-4 of max |logit| off a float64 run of the port (JAX
    3.2e-4, port 4.5e-4 at max |logit| 4.0), so atol is 2e-4 of max |logit|."""
    import jax

    sys.path.insert(0, str(REPO))
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    want = np.asarray(jax.jit(fn)(*args))
    params, *inputs = args
    (ids, media_idx, use_media, positions, attn_mask, images, videos, block_perm,
     boxes, box_idx) = [torch.from_numpy(np.array(a)) for a in inputs]
    f32 = torch.float32
    cfg = tvm.VitronConfig(
        llm=LlamaConfig(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                        num_heads=4, num_kv_heads=4, max_seq_len=256, param_dtype=f32,
                        compute_dtype=f32),
        image_tower=ViTConfig.tiny(hidden_size=64, num_heads=4),
        video_tower=ViTConfig.tiny(hidden_size=64, num_heads=4, add_time_attn=True))
    got, _ = tvm.forward(from_jax(_np_tree(params), "cpu"), cfg, ids.long(), media_idx.long(),
                         use_media, positions.long(), attn_mask, images=images, videos=videos,
                         block_perm=block_perm.long(), region_boxes=boxes,
                         region_block_idx=box_idx.long())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=2e-4 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def tiny_jax():
    """(JAX config, JAX params with numpy leaves) of VitronConfig.tiny()."""
    import jax

    from vitron_tpu.models import vitron_model as jvm

    cfg = jvm.VitronConfig.tiny()
    return cfg, _np_tree(jvm.init_params(jax.random.PRNGKey(0), cfg))


def _plan():
    from vitron_tpu.constants import IMAGE_TOKEN_INDEX, OBJS_TOKEN_INDEX
    from vitron_tpu.mm.splice import plan_splice

    row = [1, 5, 9, IMAGE_TOKEN_INDEX, 7, OBJS_TOKEN_INDEX, 11, 3]
    plan = plan_splice([row], ["image"], 32, image_len=16)
    px = np.random.RandomState(0).randn(1, 28, 28, 3).astype(np.float32)
    boxes = np.asarray([[2.0, 3.5, 19.0, 24.0]], np.float32)
    return plan, px, boxes


@pytest.mark.parametrize("int4", [False, True])
def test_greedy_stream_matches_jax_generator(tiny_jax, int4):
    import jax
    import jax.numpy as jnp

    from vitron_tpu.kernels.quantization import quantize_llama
    from vitron_tpu.runtime import generation as jgen

    jcfg, params = tiny_jax
    if int4:
        params = dict(params)
        params["llm"] = _np_tree(quantize_llama(jax.tree.map(jnp.asarray, params["llm"]),
                                                bits=4, head=True))
    plan, px, boxes = _plan()
    n = 12
    jout = jgen.Generator(jax.tree.map(jnp.asarray, params), jcfg).generate(
        plan, images=jnp.asarray(px), region_boxes=boxes, speculative=False,
        sampling=jgen.SamplingConfig(greedy=True, max_new_tokens=n, eos_ids=()))
    tgen_ = tgen.Generator(from_jax(params, "cpu"), tvm.VitronConfig.tiny())
    for chunk in (None, 0, 5):  # auto, per-token, chunks of 5
        tout = tgen_.generate(plan, images=torch.from_numpy(px), region_boxes=boxes,
                              sampling=tgen.SamplingConfig(greedy=True, max_new_tokens=n,
                                                           eos_ids=()),
                              decode_chunk=chunk)
        assert tout == jout and len(tout[0]) == n


def test_eos_and_sampling(tiny_jax):
    """EOS ends the stream (inclusive); sampling is reproducible from a
    torch.Generator seed."""
    _, params = tiny_jax
    plan, px, boxes = _plan()
    g = tgen.Generator(from_jax(params, "cpu"), tvm.VitronConfig.tiny())
    greedy = g.generate(plan, images=torch.from_numpy(px), region_boxes=boxes,
                        sampling=tgen.SamplingConfig(greedy=True, max_new_tokens=8,
                                                     eos_ids=()))[0]
    eos = greedy[3]
    for chunk in (0, 4):
        cut = g.generate(plan, images=torch.from_numpy(px), region_boxes=boxes,
                         decode_chunk=chunk,
                         sampling=tgen.SamplingConfig(greedy=True, max_new_tokens=8,
                                                      eos_ids=(eos,)))[0]
        assert cut == greedy[:greedy.index(eos) + 1]
    hot = tgen.SamplingConfig(temperature=1.0, top_p=0.9, max_new_tokens=8, eos_ids=())
    a, b = (g.generate(plan, images=torch.from_numpy(px), region_boxes=boxes, sampling=hot,
                       gen=torch.Generator().manual_seed(7))[0] for _ in range(2))
    assert a == b and len(a) == 8
    # speculation is ported: speculative=True on a greedy request gives the
    # greedy tokens and records its stats
    spec = g.generate(plan, images=torch.from_numpy(px), region_boxes=boxes, speculative=True,
                      sampling=tgen.SamplingConfig(greedy=True, max_new_tokens=8, eos_ids=()))
    assert spec[0] == greedy and g.last_spec_stats["emitted"] == 8


def test_system_chat_matches_jax(tiny_jax, monkeypatch):
    import jax
    import jax.numpy as jnp

    from vitron_tpu.runtime.engine import VitronEngine as JEngine
    from vitron_tpu.runtime.generation import SamplingConfig as JSampling
    from vitron_tpu.runtime.system import VitronSystem as JSystem

    monkeypatch.setenv("VITRON_SPEC", "0")  # the JAX chat would otherwise probe (C1)
    jcfg, params = tiny_jax
    img = np.random.RandomState(1).randint(0, 256, (64, 48, 3), np.uint8)
    kw = dict(image=img, region_box=[5.0, 8.0, 40.0, 50.0])
    want = JSystem(JEngine(jax.tree.map(jnp.asarray, params), jcfg, DemoTokenizer())).chat(
        "what is in the box?", sampling=JSampling(greedy=True, max_new_tokens=10, eos_ids=()),
        **kw)
    got = VitronSystem(VitronEngine(from_jax(params, "cpu"), tvm.VitronConfig.tiny(),
                                    DemoTokenizer()),
                       memory_plan=MemoryPlan(budget_bytes=8 << 30)).chat(
        "what is in the box?",
        sampling=tgen.SamplingConfig(greedy=True, max_new_tokens=10, eos_ids=()), **kw)
    assert got["reply"]["raw"] == want["reply"]["raw"] and got["status"] == want["status"]
    assert len(got["reply"]["raw"].split()) == 10


def test_tool_call_routes_to_unavailable_backend(tiny_jax):
    """With no task backend registered, a routed reply is answered as
    unavailable, as in the JAX system."""
    from vitron_tpu.runtime.router import route_model_output

    _, params = tiny_jax
    system = VitronSystem(VitronEngine(from_jax(params, "cpu"), tvm.VitronConfig.tiny(),
                                       DemoTokenizer()),
                          memory_plan=MemoryPlan(budget_bytes=8 << 30))
    out = route_model_output(system.registry,
                             "<module>D</module> <instruction>a dog</instruction>")
    assert out["status"] == "unavailable"


_NO_JAX = r'''
import importlib, importlib.abc, pkgutil, sys

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
import numpy as np
import torch
import vitron_tpu_torch
for m in pkgutil.walk_packages(vitron_tpu_torch.__path__, "vitron_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from vitron_tpu_torch.apps.cli import build_demo_system
from vitron_tpu_torch.runtime.generation import SamplingConfig
out = build_demo_system(torch.device("cpu")).chat(
    "hello there", image=np.random.RandomState(0).randint(0, 256, (40, 50, 3), np.uint8),
    region_box=[1.0, 2.0, 30.0, 40.0],
    sampling=SamplingConfig(greedy=True, max_new_tokens=4, eos_ids=()))
assert len(out["reply"]["tokens"]) == 4, out
assert not any(k.split(".")[0] in ("jax", "jaxlib") for k in sys.modules)
print("NO_JAX_OK", out["status"])
'''


def test_port_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK chat" in proc.stdout


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(capsys):
    from vitron_tpu_torch.apps import cli

    assert cli.build_argparser().parse_args(["--prompt", "hi"]).device == "cuda"
    assert cli.build_argparser().parse_args(["--prompt", "hi", "--device", "cpu"]).device == "cpu"
    if not torch.cuda.is_available():  # the default is an error here, never the CPU
        assert cli.main(["--demo", "--prompt", "hi"]) == 2
        assert "no CUDA device" in capsys.readouterr().err
