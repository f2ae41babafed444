"""The port's serving stack on a mesh (`runtime/sharded_serving.py`) on 2
and 4 gloo ranks against the JAX package's `install_mesh` system on its
8-device virtual CPU mesh (tests/conftest.py), at `VitronConfig.tiny()`
with JAX's params (float32, and int4 LLM projections and head):

- one planned image turn's greedy tokens after `install_mesh` equal JAX's
  sharded system's and the port's unsharded ones, on every rank;
- the batcher on the mesh: two co-batched greedy chats and a sampled one
  (its own generator) served by rank 0 while the other ranks follow in
  lockstep give the unsharded batcher's tokens;
- `build_system_from_weights(mesh=...)` on a chat-only weights dir: the
  report's mesh row, the unsharded load's tokens and prefill logits;
- the memory plan's per-device rows against JAX's `MemoryPlan(chips=n)`
  with the same entry; the caches' KV heads split over `tensor`;
- `resolve_serving_mesh`'s forms and `kv_cache_shardings` against JAX's,
  its indivisible-KV fallback, and a forward whose KV heads do not divide
  (3 over tensor=2: the attention runs whole) against the dense one within
  1e-5 (float32 partial sums added in another order).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from vitron_tpu.kernels.quantization import quantize_llama
from vitron_tpu.models import vitron_model as jvm
from vitron_tpu.runtime import sharded_serving as jss
from vitron_tpu.runtime.engine import VitronEngine as JaxEngine
from vitron_tpu.runtime.generation import SamplingConfig as JaxSampling
from vitron_tpu.runtime.memory_plan import MemoryPlan as JaxPlan
from vitron_tpu.runtime.system import VitronSystem as JaxSystem
from vitron_tpu_torch.apps.cli import DemoTokenizer
from vitron_tpu_torch.mm.splice import plan_splice
from vitron_tpu_torch.models.llm import llama as tl
from vitron_tpu_torch.runtime import sharded_serving as tss

import torch_dist
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NEW = 10
PROMPTS = ["hello number 0", "say something about the sea"]


@pytest.fixture(scope="module")
def inputs():
    from vitron_tpu_torch.constants import IMAGE_TOKEN_INDEX

    cfg = jvm.VitronConfig.tiny()
    params = jax.tree.map(np.asarray, jvm.init_params(jax.random.PRNGKey(0), cfg))
    q = dict(params)
    q["llm"] = jax.tree.map(np.asarray, quantize_llama(jax.tree.map(jnp.asarray, params["llm"]),
                                                       bits=4, head=True))
    plan = plan_splice([[1, 5, 9, IMAGE_TOKEN_INDEX, 7, 11, 3]], ["image"], 32, image_len=16)
    px = np.random.RandomState(0).randn(1, 28, 28, 3).astype(np.float32)
    return cfg, params, q, plan, px


@pytest.fixture(scope="module")
def jax_tokens(inputs):
    """JAX's install_mesh system (serving_mesh(8)): the turn's greedy tokens."""
    cfg, params, q, plan, px = inputs
    out = {}
    for name, p in (("f32", params), ("int4", q)):
        system = JaxSystem(JaxEngine(jax.tree.map(jnp.asarray, p), cfg, DemoTokenizer()))
        jss.install_mesh(system, jss.serving_mesh(8))
        out[name] = list(system.engine.generator.generate(
            plan, images=jnp.asarray(px),
            sampling=JaxSampling(greedy=True, max_new_tokens=NEW, eos_ids=()),
            decode_chunk=4)[0])
    return out


@pytest.fixture(scope="module")
def weights_dir(tmp_path_factory):
    """A chat-only weights dir (tests/synthetic_weights' tiny Vicuna + LoRA +
    towers and the CLIP tokenizer): the other components are reported
    missing."""
    from tests.synthetic_weights import build_clip_tokenizer, build_llama_lora_clip

    w = tmp_path_factory.mktemp("weights")
    build_llama_lora_clip(w, "tiny")
    build_clip_tokenizer(w)
    return str(w)


@pytest.fixture(scope="module")
def ranks(inputs, weights_dir, tmp_path_factory):
    _, params, q, plan, px = inputs
    return {n: torch_dist.run(n, "torch_mesh_bodies:serving_checks", params, q, plan, px,
                              PROMPTS, weights_dir, tmp=tmp_path_factory.mktemp(f"serve{n}"),
                              timeout=600)
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_greedy_tokens_match_jax_install_mesh(jax_tokens, ranks, n):
    for out in ranks[n]:
        for name in ("f32", "int4"):
            assert list(out[name + "_mesh"]) == jax_tokens[name]
            assert list(out[name + "_plain"]) == jax_tokens[name]
            assert out[name + "_kv_heads"] == (2, 2)  # 4 KV heads over tensor=2


@pytest.mark.parametrize("n", [2, 4])
def test_build_system_from_weights_on_mesh(ranks, n):
    """The loaded chat system sharded at load (JAX's `_apply_mesh` row) gives
    the unsharded load's greedy tokens, its prefill logits within 1e-5
    (float32 partial sums added in another order)."""
    for out in ranks[n]:
        row, plain, sharded, err = out["weights"]
        assert row["status"] == "loaded" and "tensor" in row["detail"]
        assert sharded == plain and len(plain) == 6
        assert err < 1e-5


@pytest.mark.parametrize("n", [2, 4])
def test_batcher_on_mesh(ranks, n):
    plain, occ_plain = ranks[n][0]["batch_plain"]
    mesh, occupancy = ranks[n][0]["batch_mesh"]
    assert [len(t) for t in mesh] == [NEW, NEW, 8]
    assert mesh == plain
    assert occupancy > 1.0  # the requests shared decode chunks
    assert all(out["batch_mesh"] is None for out in ranks[n][1:])  # followers serve nothing


@pytest.mark.parametrize("n", [2, 4])
def test_memory_plan_per_chip_rows(inputs, ranks, n):
    _, _, q, _, _ = inputs
    chips, per_chip, total, report = ranks[n][0]["plan"]
    assert chips == n
    jplan = JaxPlan(chips=n)
    want_total = jplan.add("llm+towers", jax.tree.map(jnp.asarray, q))
    assert total == want_total
    factor = round(total / per_chip)
    jplan.add("llm+towers", total, shard_factor=factor)
    assert per_chip == jplan.per_chip_bytes("llm+towers")
    assert factor > 1 and f"placement over {n} chips" in report and "GiB/chip" in report


@pytest.mark.parametrize("n", [2, 4])
def test_resolve_serving_mesh_forms(ranks, n):
    for out in ranks[n]:
        same, none, auto = out["resolve"]
        assert same and none is None
        assert auto == {"data": 1, "fsdp": n // 2, "tensor": 2, "context": 1}
    assert tss.resolve_serving_mesh(None) is None
    assert tss.resolve_serving_mesh("auto") is None  # one process: one device
    with pytest.raises(ValueError):
        tss.resolve_serving_mesh("bogus")


def test_kv_cache_sharding_falls_back_when_indivisible(ranks):
    """JAX's spec on 8 devices and the port's, from the mesh's axis sizes;
    a forward with KV heads that do not divide keeps them all on a rank."""
    mesh = types.SimpleNamespace(shape={"data": 1, "fsdp": 4, "tensor": 2, "context": 1})
    for heads in (3, 4):
        cfg = tl.LlamaConfig.tiny(num_kv_heads=heads)
        jcfg = jvm.VitronConfig.tiny().llm.__class__.tiny(num_kv_heads=heads)
        want = jss.kv_cache_shardings(jss.serving_mesh(8), jcfg)
        got = tss.kv_cache_shardings(mesh, cfg)
        assert got.k == tuple(want.k.spec) and got.v == tuple(want.v.spec)
        assert tss.paged_pool_shardings(mesh, cfg) == tuple(
            jss.paged_pool_shardings(jss.serving_mesh(8), jcfg).spec)
    assert tss.kv_cache_shardings(mesh, tl.LlamaConfig.tiny(num_kv_heads=3)).k == tuple(P())
    for n in (2, 4):
        for out in ranks[n]:
            heads, err = out["kv_fallback"]
            assert heads == 3 and err < 1e-5


def test_dryrun_serving_legs(tmp_path):
    """`apps/dryrun_multichip.run_legs` on 2 ranks (the 7B-geometry leg at
    one layer): the sharded train step first, as in JAX, its line first
    and its loss finite and the same on both ranks; the ring and the video
    step within JAX's dryrun bound of 1e-3, two co-batched chats and a
    routed task-D step served by rank 0 while rank 1 follows."""
    outs = torch_dist.run(2, "torch_mesh_bodies:dryrun_legs", tmp=tmp_path, timeout=600)
    lines = outs[0][0]
    assert lines[0].startswith("train step sharded: mesh=(1,1,2) loss=") and lines[0].endswith(
        " OK"), lines[:2]
    assert outs[1][0] == []
    assert np.isfinite(outs[0][1]) and outs[0][1] == outs[1][1]
    for rank, (_, _, ring_err, toks, video_err) in enumerate(outs):
        assert ring_err < 1e-3 and video_err < 1e-3
        assert (toks is None) == (rank > 0)
    assert [len(t) for t in outs[0][3]] == [4, 4]
