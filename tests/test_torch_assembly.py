"""Parity of the port's chat assembly from checkpoint files with the JAX
package's on the CPU: `runtime/assembly.build_mllm_system` on the synthetic
HF-layout dir of `tests/synthetic_weights.build_llama_lora_clip(w, "tiny")`
(the Llama shard rewritten with its weights x LLM_SCALE, so that a greedy
stream is not one token repeated), against JAX's `build_mllm_system(...,
geometry="tiny")`: the report's rows, every loaded leaf bit for bit, the
same greedy tokens; the missing-tower refusal and `allow_random_towers`;
the tokenizer and device seams; `cli.main(["--base-model", ...])` against
JAX's CLI on the same pixels; `serve --base-model` answering POST /chat on
127.0.0.1; `--weights` on a missing dir exiting 2 with the reason (the
assembly itself: `test_torch_assembly_weights.py`).

Greedy streams are compared with both LLMs at float32 compute
(`llama_cfg_from_hf` patched on both sides): at the default bf16, XLA and
torch round at other places and the streams part at near-ties.
"""
import argparse
import base64
import dataclasses
import io
import json
import urllib.request

import numpy as np
import pytest
import torch

from vitron_tpu_torch.apps import cli as tcli
from vitron_tpu_torch.apps import serve as tserve
from vitron_tpu_torch.models.convert import to_numpy
from vitron_tpu_torch.runtime import assembly as tasm
from vitron_tpu_torch.runtime.generation import SamplingConfig
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LLM_SCALE = 30.0
PROMPT = "what is in this image ?"
BOX = [5.0, 5.0, 50.0, 40.0]
NEW = 12
HOST = MemoryPlan(budget_bytes=8 << 30)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    from safetensors.torch import load_file, save_file

    from tests.synthetic_weights import build_llama_lora_clip

    w = tmp_path_factory.mktemp("ckpt")
    build_llama_lora_clip(w, "tiny")
    shard = w / "vicuna-7b" / "model.safetensors"
    sd = load_file(str(shard))
    save_file({k: (v if "norm" in k else v * LLM_SCALE).contiguous() for k, v in sd.items()},
              str(shard), metadata={"format": "pt"})
    return w


def _kw(w, **extra):
    return dict(lora=str(w / "vitron_lora"), clip_tower=str(w / "clip_vit_l14"),
                video_tower=str(w / "languagebind_video"), geometry="tiny", **extra)


@pytest.fixture
def float32_llms(monkeypatch):
    """Both packages' `llama_cfg_from_hf` at float32 params and compute."""
    import jax.numpy as jnp

    from vitron_tpu.runtime import assembly as jasm

    jf, tf = jasm.llama_cfg_from_hf, tasm.llama_cfg_from_hf
    monkeypatch.setattr(jasm, "llama_cfg_from_hf", lambda base: dataclasses.replace(
        jf(base), param_dtype=jnp.float32, compute_dtype=jnp.float32))
    monkeypatch.setattr(tasm, "llama_cfg_from_hf", lambda base: dataclasses.replace(
        tf(base), param_dtype=torch.float32, compute_dtype=torch.float32))


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{pre}.{k}")
    else:
        yield pre, tree


def _jax_tokens(system, image, box, new):
    """JAX's greedy reply and its tokens (its engine returns the text only)."""
    import jax

    from vitron_tpu.runtime.generation import SamplingConfig as JSampling

    seen = {}
    tok = system.engine.tokenizer
    decode = tok.decode

    def recording(ids, **kw):
        seen["ids"] = [int(i) for i in ids]
        return decode(ids, **kw)

    tok.decode = recording
    try:
        out = system.chat(PROMPT, image=image, region_box=box,
                          sampling=JSampling(greedy=True, max_new_tokens=new),
                          rng=jax.random.PRNGKey(0))
    finally:
        tok.decode = decode
    return out["reply"]["raw"], seen["ids"]


def test_build_mllm_system_matches_jax(weights):
    """int4 at the default (bf16) params: the same report rows, every leaf
    of the LLM (LoRA merged, packed int4 and scales, lm_head included), the
    towers, the projector and the region extractor bit-equal to JAX's."""
    import jax

    from vitron_tpu.runtime import assembly as jasm

    jsys, jrep = jasm.build_mllm_system(str(weights / "vicuna-7b"), **_kw(weights,
                                                                          quantize="int4"))
    tsys, trep = tasm.build_mllm_system(str(weights / "vicuna-7b"), device="cpu",
                                        memory_plan=HOST, **_kw(weights, quantize="int4"))
    assert trep.rows == jrep.rows and trep.summary() == jrep.summary()
    assert trep.loaded() == ["llm", "image_tower", "video_tower", "projector",
                             "region_extractor"]
    want = dict(_flat(jax.tree.map(
        lambda a: np.asarray(a, np.float32) if a.dtype.name == "bfloat16" else np.asarray(a),
        jsys.engine.generator.params)))
    got = dict(_flat(to_numpy(tsys.engine.generator.params)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert tsys.engine.generator.cfg.llm.attn_impl == "xla"
    assert tsys.engine.generator.params["llm"]["layers"]["wq"]["q4"].dtype == torch.int8


@pytest.mark.parametrize("box", [None, BOX], ids=["image", "image+box"])
def test_greedy_stream_matches_jax(weights, float32_llms, box):
    from vitron_tpu.runtime import assembly as jasm

    image = np.random.RandomState(0).randint(0, 256, (60, 80, 3), np.uint8)
    jsys, _ = jasm.build_mllm_system(str(weights / "vicuna-7b"), **_kw(weights,
                                                                       quantize="int4"))
    tsys, _ = tasm.build_mllm_system(str(weights / "vicuna-7b"), device="cpu",
                                     memory_plan=HOST, **_kw(weights, quantize="int4"))
    raw, ids = _jax_tokens(jsys, image, box, NEW)
    out = tsys.chat(PROMPT, image=image, region_box=box,
                    sampling=SamplingConfig(greedy=True, max_new_tokens=NEW))
    assert out["reply"]["tokens"] == ids and out["reply"]["raw"] == raw
    assert len(set(ids)) > 3  # not one token repeated


def test_missing_tower_is_refused_unless_allowed(weights, tmp_path):
    """Without a CLIP tower both packages refuse; allow_random_towers builds
    with the same "missing" rows, and the random towers at the tiny
    geometry's shapes."""
    from vitron_tpu.runtime import assembly as jasm

    base = str(weights / "vicuna-7b")
    kw = dict(lora=str(weights / "vitron_lora"), geometry="tiny")
    with pytest.raises(jasm.MissingWeightsError, match="HF CLIP vision tower"):
        jasm.build_mllm_system(base, **kw)
    with pytest.raises(tasm.MissingWeightsError, match="HF CLIP vision tower"):
        tasm.build_mllm_system(base, device="cpu", memory_plan=HOST, **kw)
    with pytest.raises(tasm.MissingWeightsError, match="HF llama dir"):
        tasm.build_mllm_system(str(tmp_path / "absent"), device="cpu", memory_plan=HOST)
    _, jrep = jasm.build_mllm_system(base, allow_random_towers=True, **kw)
    tsys, trep = tasm.build_mllm_system(base, allow_random_towers=True, device="cpu",
                                        memory_plan=HOST, **kw)
    assert trep.rows == jrep.rows
    assert trep.rows["image_tower"]["status"] == "missing"
    cfg = tsys.engine.generator.cfg
    params = tsys.engine.generator.params
    assert params["image_tower"]["patch_proj"].shape == (
        cfg.image_tower.patch_size ** 2 * 3, cfg.image_tower.hidden_size)


def test_tokenizer_device_and_mesh_seams(weights, monkeypatch):
    """tokenizer=None without transformers is a MissingWeightsError naming
    the package; a given tokenizer is used as it is; the default device
    without a card is an error, never the CPU; mesh "auto" on one device is
    JAX's "skipped" row, any other mesh names A16."""
    import sys

    base = str(weights / "vicuna-7b")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(tasm.MissingWeightsError, match="transformers"):
        tasm.build_mllm_system(base, device="cpu", memory_plan=HOST, **_kw(weights))
    tok = tcli.DemoTokenizer()
    sys_, rep = tasm.build_mllm_system(base, device="cpu", memory_plan=HOST, tokenizer=tok,
                                       mesh="auto", **_kw(weights))
    assert sys_.engine.tokenizer is tok
    assert rep.rows["mesh"] == {"status": "skipped", "detail": "single device — replicated"}
    with pytest.raises(NotImplementedError, match="A16"):
        tasm.build_mllm_system(base, device="cpu", memory_plan=HOST, tokenizer=tok,
                               mesh=object(), **_kw(weights))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tasm.build_mllm_system(base, tokenizer=tok, **_kw(weights))


def test_mesh_over_several_cards_is_refused_before_loading(weights, capsys, monkeypatch):
    """With more than one card, `--mesh auto` (the default) is refused
    naming A16 before any checkpoint is read (the base dir here does not
    exist, which a load would report first), and both entry points exit 2
    with the message."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    absent = str(weights / "absent")
    with pytest.raises(NotImplementedError, match="A16"):
        tasm.build_mllm_system(absent, mesh="auto", tokenizer=tcli.DemoTokenizer())
    for main in (tcli.main, tserve.main):
        args = ["--base-model", absent, "--device", "cuda"]
        assert main(args + (["--prompt", "hi"] if main is tcli.main else [])) == 2
        assert "A16" in capsys.readouterr().err


def test_cli_base_model_matches_jax_cli(weights, float32_llms, tmp_path, capsys, monkeypatch):
    """`cli.main(["--base-model", ...])` on a .npy image against JAX's CLI on
    the same pixels as a PNG (its system built by JAX's own
    `build_serving_system`): the same reply line."""
    from PIL import Image

    from vitron_tpu.apps import cli as jcli

    image = np.random.RandomState(1).randint(0, 256, (60, 80, 3), np.uint8)
    np.save(tmp_path / "x.npy", image)
    Image.fromarray(image).save(tmp_path / "x.png")
    flags = ["--base-model", str(weights / "vicuna-7b"), "--lora", str(weights / "vitron_lora"),
             "--clip-tower", str(weights / "clip_vit_l14"), "--video-tower",
             str(weights / "languagebind_video"), "--geometry", "tiny", "--quantize", "int4",
             "--mesh", "none", "--prompt", PROMPT, "--greedy", "--max-new-tokens", str(NEW),
             "--bbox", *map(str, BOX)]
    assert tcli.main(flags + ["--device", "cpu", "--image", str(tmp_path / "x.npy")]) == 0
    out = capsys.readouterr()
    got = [line for line in out.out.splitlines() if line.startswith("[reply]")]
    assert "llm" in out.err and "loaded" in out.err  # the report goes to stderr
    import vitron_tpu.utils.compile_cache as jcc

    monkeypatch.setattr(jcc, "enable_compile_cache", lambda *a, **k: None)  # no cache dir
    assert jcli.main(flags + ["--cpu", "--image", str(tmp_path / "x.png")]) == 0
    want = [line for line in capsys.readouterr().out.splitlines()
            if line.startswith("[reply]")]
    assert got == want and len(got) == 1


def test_cli_and_serve_refuse_what_is_not_ported(weights, tmp_path, capsys):
    """`--weights` now builds the A-G assembly (ported: it no longer names
    A14); a weights dir that does not exist, and a missing component, are
    exit 2 with the reason."""
    for main in (tcli.main, tserve.main):
        args = ["--weights", str(tmp_path / "absent"), "--device", "cpu"]
        assert main(args + (["--prompt", "hi"] if main is tcli.main else [])) == 2
        err = capsys.readouterr().err
        assert "does not exist" in err and "A14" not in err
    assert tcli.main(["--base-model", str(weights / "vicuna-7b"), "--device", "cpu",
                      "--prompt", "hi"]) == 2
    assert "HF CLIP vision tower" in capsys.readouterr().err


def test_serve_base_model_answers_chat(weights, float32_llms):
    """`serve --base-model` (its flags through `build_serving_system`, the
    host's memory as the plan's budget off the card) answers POST /chat on
    127.0.0.1 with the direct chat's reply (the server's batched, staged
    path against the single stream: float32, where the two orders of sums
    give the same greedy tokens)."""
    from PIL import Image

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cpu")
    tserve.add_checkpoint_args(p)
    args = p.parse_args(["--base-model", str(weights / "vicuna-7b"), "--lora",
                         str(weights / "vitron_lora"), "--clip-tower",
                         str(weights / "clip_vit_l14"), "--geometry", "tiny",
                         "--quantize", "int4"])
    system, report = tserve.build_serving_system(args)
    assert report.rows["mesh"]["status"] == "skipped"
    assert system.memory_plan.budget_bytes == tserve.host_memory_bytes()
    image = np.random.RandomState(2).randint(0, 256, (60, 80, 3), np.uint8)
    direct = system.chat(PROMPT, image=image, region_box=BOX,
                         sampling=SamplingConfig(greedy=True, max_new_tokens=NEW))
    srv = tserve.serve(system, host="127.0.0.1", port=0, background=True)
    try:
        buf = io.BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        body = json.dumps({"prompt": PROMPT, "image": base64.b64encode(buf.getvalue()).decode(),
                           "region": BOX, "greedy": True, "max_new_tokens": NEW}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/chat",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            reply = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
        srv.pipeline.close()
    assert reply["status"] == "chat" and reply["raw"] == direct["reply"]["raw"]
