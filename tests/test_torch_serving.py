"""The port's serving stack against the JAX package on the CPU.

At `LlamaConfig.tiny()` / `VitronConfig.tiny()`, with the JAX package's
parameters carried across by `models/convert.from_jax` and inputs from
numpy seeds:
- the device-position decode step (`llama.decode_step`, the step a CUDA
  graph captures) against the host-index path and JAX's `decode_step`,
  float32 and int4, at the tolerance of tests/test_torch_llama.py;
- `generate_scan` against JAX's, float32 and int4 (identical greedy tokens),
  and the Generator's decode chunks and their `ProgramCache`;
- `ContinuousBatcher` (the cases of the JAX package's
  tests/test_serve_batching.py): batched greedy equals the single stream and
  JAX's batcher, co-batching, mixed sampling, staged admission, the
  interleaving trace, a short prompt admitted during a staged admission,
  `close()`;
- `telemetry` (tests/test_telemetry.py's four cases on the port's copy),
  `memory_plan`, `pipeline.MediaPrefetcher` against JAX's;
- `apps/serve.py` (tests/test_serve.py's six cases on the port's `--demo`
  system on the CPU: the same status codes and response keys as JAX's
  server), /stats' batching, and `main`'s device and checkpoint errors.
Every threaded test waits with a timeout and closes its batcher or server
in `finally`.
"""
import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from vitron_tpu_torch.apps.cli import DEMO_HOST_BUDGET, DemoTokenizer
from vitron_tpu_torch.models import vitron_model as tvm
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.llm import llama as tl
from vitron_tpu_torch.runtime import generation as tgen
from vitron_tpu_torch.runtime import telemetry
from vitron_tpu_torch.runtime.batching import ContinuousBatcher
from vitron_tpu_torch.runtime.engine import VitronEngine
from vitron_tpu_torch.runtime.generation import SamplingConfig
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan, tree_bytes
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = ATOL = 1e-4  # float32, as tests/test_torch_llama.py
WAIT = 300  # seconds any future or server call may take here
HOST_BUDGET = 8 * 1024 ** 3  # the memory plan's budget off the card


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_tiny():
    """(JAX VitronConfig.tiny(), its params as numpy, the same with int4 LLM
    projections and head)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.kernels.quantization import quantize_llama
    from vitron_tpu.models import vitron_model as jvm

    cfg = jvm.VitronConfig.tiny()
    params = _np_tree(jvm.init_params(jax.random.PRNGKey(0), cfg))
    q = dict(params)
    q["llm"] = _np_tree(quantize_llama(jax.tree.map(jnp.asarray, params["llm"]), bits=4,
                                       head=True))
    return cfg, params, q


@pytest.fixture(scope="module")
def engine(jax_tiny):
    _, params, _ = jax_tiny
    return VitronEngine(from_jax(params, "cpu"), tvm.VitronConfig.tiny(), DemoTokenizer())


def _plan(seed=0):
    """An image prompt's splice plan and pixels."""
    from vitron_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from vitron_tpu_torch.mm.splice import plan_splice

    row = [1, 5, 9, IMAGE_TOKEN_INDEX, 7, 11, 3]
    plan = plan_splice([row], ["image"], 32, image_len=16)
    px = np.random.RandomState(seed).randn(1, 28, 28, 3).astype(np.float32)
    return plan, px


def _arrays(plan):
    return (plan.token_ids, plan.media_idx, plan.use_media, plan.position_ids,
            plan.attention_mask, plan.seq_lens)


# ------------------------------------------------- the device-position step

@pytest.mark.parametrize("int4", [False, True])
def test_decode_step_at_device_index(jax_tiny, int4):
    """A prefill, then three decode tokens at a slot held in a device
    tensor: the logits equal the host-index path's exactly (the same
    operations) and JAX's decode_step within 1e-4; `cache.index` (the host
    fill level) stays where the prefill left it."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.models.llm import llama as jl

    jcfg, params, qparams = jax_tiny
    p = qparams if int4 else params
    cfg = tvm.VitronConfig.tiny()
    tp_ = from_jax(p, "cpu")
    rs = np.random.RandomState(3)
    ids = rs.randint(0, 256, (2, 6)).astype(np.int32)
    toks = rs.randint(0, 256, (3, 2, 1)).astype(np.int32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    jp = jax.tree.map(jnp.asarray, p)
    jcache = jl.KVCache.create(jcfg.llm, 2, max_len=12)
    _, jcache = jl.forward_tokens(jp["llm"], jcfg.llm, jnp.asarray(ids),
                                  positions=jnp.asarray(pos), cache=jcache)
    dev_cache = tl.KVCache.create(cfg.llm, 2, max_len=12)
    host_cache = tl.KVCache.create(cfg.llm, 2, max_len=12)
    for c in (dev_cache, host_cache):
        tl.forward_tokens(tp_["llm"], cfg.llm, torch.from_numpy(ids).long(),
                          positions=torch.from_numpy(pos.copy()).long(), cache=c)
    index = torch.tensor([6])
    for i in range(3):
        tok = torch.from_numpy(toks[i]).long()
        p_i = torch.full((2, 1), 6 + i)
        got, _ = tvm.decode_step(tp_, cfg, tok, p_i, dev_cache, index)
        host, _ = tvm.decode_step(tp_, cfg, tok, p_i, host_cache)
        want, jcache = jvm.decode_step(jp, jcfg, jnp.asarray(toks[i]),
                                       jnp.full((2, 1), 6 + i, jnp.int32), jcache)
        np.testing.assert_array_equal(got.numpy(), host.numpy())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        index += 1
    assert dev_cache.index == 6 and host_cache.index == 9
    np.testing.assert_array_equal(dev_cache.k.numpy(), host_cache.k.numpy())
    np.testing.assert_array_equal(dev_cache.valid.numpy(), host_cache.valid.numpy())


# ------------------------------------------------------------ generate_scan

@pytest.mark.parametrize("int4", [False, True])
def test_generate_scan_matches_jax(jax_tiny, int4):
    import jax
    import jax.numpy as jnp

    from vitron_tpu.runtime.generation import generate_scan as jax_scan

    jcfg, params, qparams = jax_tiny
    p = qparams if int4 else params
    plan, px = _plan()
    want = np.asarray(jax_scan(jax.tree.map(jnp.asarray, p), jcfg,
                               tuple(jnp.asarray(a) for a in _arrays(plan)), 10,
                               jax.random.PRNGKey(0), images=jnp.asarray(px)))
    gen_ = tgen.Generator(from_jax(p, "cpu"), tvm.VitronConfig.tiny())
    got = tgen.generate_scan(gen_.params, gen_.cfg, _arrays(plan), 10,
                             images=torch.from_numpy(px), generator=gen_)
    assert got.shape == (1, 10) and got.tolist() == want.tolist()
    # the chunk is kept: a second call reuses it and gives the same tokens
    again = tgen.generate_scan(gen_.params, gen_.cfg, _arrays(plan), 10,
                               images=torch.from_numpy(px), generator=gen_)
    assert again.tolist() == want.tolist()
    st = gen_.chunks.stats()
    assert (st["programs"], st["hits"], st["misses"]) == (1, 1, 1)
    assert (9, 1, 512, False) in gen_.chunks  # 32 + 10 slots: the least length


def test_decode_chunks_are_cached_per_bucket(jax_tiny):
    """The Generator's chunks live in a ProgramCache keyed by (steps, batch,
    cache length, sampled): a request's chunks have `decode_chunk` steps and
    the last one runs all of them (the cache has room for them; the host
    drops the extra tokens); the cache length is a power of two, so another
    pad bucket or budget within it reuses the chunk; sampled decoding is
    reproducible from a torch.Generator seed."""
    from vitron_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from vitron_tpu_torch.mm.splice import plan_splice

    _, params, _ = jax_tiny
    plan, px = _plan()
    g = tgen.Generator(from_jax(params, "cpu"), tvm.VitronConfig.tiny())
    greedy = SamplingConfig(greedy=True, max_new_tokens=12, eos_ids=())
    ref = g.generate(plan, images=torch.from_numpy(px), sampling=greedy, decode_chunk=0)[0]
    for chunk in (4, 5, 11, 128):
        got = g.generate(plan, images=torch.from_numpy(px), sampling=greedy,
                         decode_chunk=chunk)[0]
        assert got == ref, chunk
    steps = 11
    for chunk in (4, 5, 11, 128):
        t = tgen.cache_slots(32 + -(-steps // chunk) * chunk)
        assert (chunk, 1, t, False) in g.chunks
    assert [tgen.cache_slots(n) for n in (1, 160, 512, 513, 1100)] == [512, 512, 512, 1024,
                                                                      2048]
    # a 48-slot bucket and a budget of 8 fit the 512-slot chunk: no new graph
    row = [1, 5, 9, IMAGE_TOKEN_INDEX, 7, 11, 3]
    plan48 = plan_splice([row], ["image"], 48, image_len=16)
    short = SamplingConfig(greedy=True, max_new_tokens=8, eos_ids=())
    ref48 = g.generate(plan48, images=torch.from_numpy(px), sampling=short, decode_chunk=0)[0]
    before = g.chunks.stats()
    assert g.generate(plan48, images=torch.from_numpy(px), sampling=short,
                      decode_chunk=11)[0] == ref48 == ref[:8]
    after = g.chunks.stats()
    assert (after["programs"], after["misses"], after["hits"]) == \
        (before["programs"], before["misses"], before["hits"] + 1)
    hot = SamplingConfig(temperature=1.0, top_p=0.9, max_new_tokens=12, eos_ids=())
    runs = [g.generate(plan, images=torch.from_numpy(px), sampling=hot, decode_chunk=11,
                       gen=torch.Generator().manual_seed(5))[0] for _ in range(2)]
    assert runs[0] == runs[1] and len(runs[0]) == 12
    assert (11, 1, 512, True) in g.chunks


def test_warmup_then_replay_gives_the_same_tokens(jax_tiny, monkeypatch):
    """The card's first call of a chunk runs its warm-up step and then the
    captured steps. Emulated here (warm-up, then the body as the replay):
    the tokens and the paged pool equal those of the plain eager run, so
    the warm-up leaves the chunk's inputs as it found them."""
    from vitron_tpu_torch.models.llm import paged_cache
    from vitron_tpu_torch.runtime import graphs

    _, params, _ = jax_tiny
    plan, px = _plan()
    sampling = SamplingConfig(temperature=1.0, top_p=0.9, max_new_tokens=12, eos_ids=())

    def run():
        g = tgen.Generator(from_jax(params, "cpu"), tvm.VitronConfig.tiny())
        toks = [g.generate(plan, images=torch.from_numpy(px), sampling=s, decode_chunk=5,
                           gen=torch.Generator().manual_seed(1))[0]
                for s in (sampling, SamplingConfig(greedy=True, max_new_tokens=12))]
        srv = paged_cache.PagedServer(g.params["llm"], g.cfg.llm, num_blocks=32, block_size=4)
        sids = [srv.add_request([5, 17, 3, 99, 42]), srv.add_request([7, 8])]
        u = torch.rand((6, 2), generator=torch.Generator().manual_seed(2))
        out = srv.step_n(6, sampling={sids[0]: (1.0, 0.9, False), sids[1]: (0.0, 1.0, True),
                                      "uniforms": u})
        return toks, out, srv.pool.k.clone()

    want = run()

    def emulated(self):
        if not getattr(self, "warm", False):
            self.warm = True
            self.warmup()
        self.body()

    monkeypatch.setattr(graphs.Chunk, "__call__", emulated)
    got = run()
    assert got[0] == want[0] and got[1] == want[1]
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)


# ------------------------------------------------------- ContinuousBatcher

def _batcher(engine, **kw):
    b = ContinuousBatcher(engine.generator.params, engine.generator.cfg, **kw)
    engine.batcher = b
    return b


def _close(engine, batcher):
    engine.batcher = None
    batcher.close()


def _run_threads(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)


def test_batched_greedy_matches_single_stream_and_jax(engine, jax_tiny, monkeypatch):
    """One request through the batcher == the single-stream chunked path ==
    the JAX package's batcher on the same parameters."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.runtime.batching import ContinuousBatcher as JaxBatcher
    from vitron_tpu.runtime.engine import VitronEngine as JaxEngine
    from vitron_tpu.runtime.generation import SamplingConfig as JaxSampling

    monkeypatch.setenv("VITRON_SPEC", "0")
    jcfg, params, _ = jax_tiny
    sampling = SamplingConfig(greedy=True, max_new_tokens=12)
    single = engine.chat("hello there", sampling=sampling)
    batcher = _batcher(engine, chunk=4, num_blocks=64)
    try:
        batched = engine.chat("hello there", sampling=sampling)
    finally:
        _close(engine, batcher)
    jengine = JaxEngine(jax.tree.map(jnp.asarray, params), jcfg, DemoTokenizer())
    jb = JaxBatcher(jengine.generator.params, jcfg, chunk=4, num_blocks=64)
    jengine.batcher = jb
    try:
        want = jengine.chat("hello there", sampling=JaxSampling(greedy=True, max_new_tokens=12))
    finally:
        jengine.batcher = None
        jb.close()
    assert batched["raw"] == single["raw"] == want["raw"]


def test_concurrent_jobs_cobatch(engine):
    """A burst of 4 greedy requests decodes with mean batch occupancy > 1.5;
    every request matches its solo output."""
    sampling = SamplingConfig(greedy=True, max_new_tokens=10)
    prompts = [f"prompt number {i} words" for i in range(4)]
    solo = [engine.chat(p, sampling=sampling)["raw"] for p in prompts]
    batcher = _batcher(engine, chunk=4, num_blocks=128)
    results = [None] * 4

    def run(i):
        results[i] = engine.chat(prompts[i], sampling=sampling)["raw"]

    try:
        _run_threads([lambda i=i: run(i) for i in range(4)])
        stats = batcher.stats()
    finally:
        _close(engine, batcher)
    assert results == solo
    assert stats["admitted"] == 4 and stats["finished"] == 4
    assert stats["mean_batch_occupancy"] > 1.5, stats
    assert 0 < stats["slot_efficiency"] <= 1


def test_mixed_sampling_cobatch(engine):
    """Greedy and nucleus-sampled rows share one chunk: the greedy row
    equals its solo output, and the sampled row gives the same tokens twice
    from one torch.Generator seed (its uniforms come from its own
    generator, whatever shares its chunks)."""
    greedy = SamplingConfig(greedy=True, max_new_tokens=8, eos_ids=())
    hot = SamplingConfig(temperature=0.9, top_p=0.9, max_new_tokens=8, eos_ids=())
    solo = engine.chat("mixed batch", sampling=greedy)["tokens"]
    runs = []
    for _ in range(2):
        batcher = _batcher(engine, chunk=4, num_blocks=128)
        out = {}
        try:
            _run_threads([
                lambda: out.__setitem__("greedy", engine.chat(
                    "mixed batch", sampling=greedy)["tokens"]),
                lambda: out.__setitem__("sampled", engine.chat(
                    "mixed batch", sampling=hot, gen=torch.Generator().manual_seed(3))["tokens"]),
            ])
        finally:
            _close(engine, batcher)
        runs.append(out)
    assert runs[0]["greedy"] == runs[1]["greedy"] == solo
    assert runs[0]["sampled"] == runs[1]["sampled"] and len(runs[0]["sampled"]) == 8


def test_staged_admission_matches_single_stream(engine):
    """A LONG prompt (pad bucket > prefill_chunk) is admitted in stages
    (embeddings, then cache-offset prefill chunks) and produces exactly the
    single-stream greedy output."""
    sampling = SamplingConfig(greedy=True, max_new_tokens=12)
    prompt = " ".join(f"w{i}" for i in range(200))  # seq ~201 -> pad 256
    single = engine.chat(prompt, sampling=sampling)
    batcher = _batcher(engine, chunk=4, num_blocks=128, prefill_chunk=128)
    try:
        batched = engine.chat(prompt, sampling=sampling)
        trace = list(batcher._trace)
    finally:
        _close(engine, batcher)
    assert batched["raw"] == single["raw"]
    assert trace.count("admit_embed") == 1, trace
    assert trace.count("admit_chunk") == 2, trace  # ceil(201/128)
    assert "admit_fused" not in trace


def test_staged_chunks_are_prefill_chunk_wide(engine, monkeypatch):
    """A 384-slot bucket with prefill_chunk 256 is prefilled as 256 + 128
    slots (the JAX package's gcd would give three chunks of 128)."""
    prompt = " ".join(f"w{i}" for i in range(300))  # pad 384
    sampling = SamplingConfig(greedy=True, max_new_tokens=4)
    seen = []
    fwd = tl.forward

    def spy(params, cfg, embeds, positions, **kw):
        if kw.get("cache") is not None:
            seen.append((embeds.shape[1], kw["cache"].index))
        return fwd(params, cfg, embeds, positions, **kw)

    single = engine.chat(prompt, sampling=sampling)
    batcher = _batcher(engine, chunk=4, num_blocks=128, prefill_chunk=256)
    try:
        monkeypatch.setattr(tl, "forward", spy)
        batched = engine.chat(prompt, sampling=sampling)
    finally:
        _close(engine, batcher)
    assert seen == [(256, 0), (128, 256)]
    assert batched["raw"] == single["raw"]


def test_staged_admission_interleaves_with_decode(engine):
    """While one stream decodes, a long-prompt admission advances one
    device step per loop iteration with a decode chunk in between."""
    batcher = _batcher(engine, chunk=4, num_blocks=256, prefill_chunk=128)
    long_prompt = " ".join(f"w{i}" for i in range(300))  # pad 384 -> 3 chunks
    out = {}

    def run(name, prompt, n):
        out[name] = engine.chat(prompt, sampling=SamplingConfig(
            greedy=True, max_new_tokens=n))["raw"]

    try:
        t1 = threading.Thread(target=run, args=("short", "hello stream", 64))
        t1.start()
        while "decode" not in batcher._trace and t1.is_alive():
            time.sleep(0.001)
        t2 = threading.Thread(target=run, args=("long", long_prompt, 8))
        t2.start()
        t1.join(timeout=WAIT)
        t2.join(timeout=WAIT)
        trace = list(batcher._trace)
        stats = batcher.stats()
    finally:
        _close(engine, batcher)
    assert not t1.is_alive() and not t2.is_alive()
    assert out["short"] and out["long"]
    admit_idx = [i for i, e in enumerate(trace)
                 if e.startswith("admit_") and i > trace.index("decode")]
    assert len(admit_idx) == 4, trace  # embed + 3 chunks, all while the short one decodes
    for a, b in zip(admit_idx, admit_idx[1:]):
        assert b - a >= 2, (a, b, trace)  # a decode ran in between
    assert stats["admit_steps"] >= 5  # fused(short) + embed + 3 chunks
    assert stats["admit_step_s_max"] > 0


def test_short_prompt_admitted_during_staged_admission(engine):
    """A short prompt queued while a long one is being admitted in stages
    is admitted before that admission ends (the JAX loop kept it queued
    until the last chunk). The long prompt's embeddings step waits until
    the short prompt is queued."""
    batcher = ContinuousBatcher(engine.generator.params, engine.generator.cfg, chunk=4,
                                num_blocks=256, prefill_chunk=128)
    queued = threading.Event()
    embed = batcher._embed_fn
    batcher._embed_fn = lambda job: queued.wait(WAIT) and embed(job)
    sampling = SamplingConfig(greedy=True, max_new_tokens=8)
    long_plan = engine.plan_turn(" ".join(f"w{i}" for i in range(300)))[0]  # 3 chunks
    short_plan = engine.plan_turn("hi")[0]
    try:
        long_fut = batcher.submit(long_plan, sampling=sampling)
        t0 = time.perf_counter()
        while batcher._admitting is None and time.perf_counter() - t0 < WAIT:
            time.sleep(0.001)
        short_fut = batcher.submit(short_plan, sampling=sampling)
        queued.set()
        assert len(long_fut.result(timeout=WAIT)) == len(short_fut.result(timeout=WAIT)) == 8
        trace = list(batcher._trace)
    finally:
        queued.set()
        batcher.close()
    chunks = [i for i, e in enumerate(trace) if e == "admit_chunk"]
    assert trace.index("admit_embed") < trace.index("admit_fused") < chunks[0], trace
    assert len(chunks) == 3


def test_batcher_close_and_mesh(engine):
    """close() joins the loop thread, then fails what it did not finish;
    submit after close raises; a mesh that is no `core.mesh.Mesh` is
    refused."""
    batcher = ContinuousBatcher(engine.generator.params, engine.generator.cfg, chunk=4,
                                num_blocks=64)
    plan, _, _, _, _ = engine.plan_turn("hello there")
    fut = batcher.submit(plan, sampling=SamplingConfig(greedy=True, max_new_tokens=100000))
    batcher.close()
    assert not batcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="batcher closed"):
        fut.result(timeout=WAIT)
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(plan)
    with pytest.raises(TypeError, match="Mesh"):
        ContinuousBatcher(engine.generator.params, engine.generator.cfg, mesh=object())


# ---------------------------------------------------------------- telemetry

def test_lru_bounds_and_counters():
    c = telemetry.ProgramCache("t", max_entries=4, register=False)
    for i in range(10):
        c.get(i, lambda i=i: f"prog{i}")
    assert len(c) == 4
    assert c.stats()["evictions"] == 6
    assert c.stats()["misses"] == 10
    assert 9 in c and 6 in c and 0 not in c
    c.get(9, lambda: "x")
    assert c.stats()["hits"] == 1


def test_lookup_store_api():
    c = telemetry.ProgramCache("t2", max_entries=2, register=False)
    assert c.lookup("a") is None
    c.store("a", 1)
    assert c.lookup("a") == 1
    c.store("b", 2)
    c.store("c", 3)
    assert len(c) == 2 and "a" not in c


def test_paged_server_chunk_cache_bounded_under_churn(jax_tiny):
    """Batch-size churn across step_n calls does not accumulate captured
    chunks past the cache bound."""
    from vitron_tpu_torch.models.llm import paged_cache

    _, params, _ = jax_tiny
    cfg = tl.LlamaConfig.tiny()
    srv = paged_cache.PagedServer(from_jax(params["llm"], "cpu"), cfg, num_blocks=64,
                                  block_size=4, max_blocks_per_seq=8)
    srv._chunk_fns.max_entries = 3
    for _ in range(1, 6):  # five distinct active-batch sizes
        srv.add_request([1, 2, 3])
        srv.step_n(2)
    st = srv._chunk_fns.stats()
    assert st["programs"] <= 3
    assert st["evictions"] >= 2
    assert len(srv.step_n(1)) == 5  # and the decode still works after evictions


def test_registry_and_stats_shape():
    c = telemetry.ProgramCache("unit-test-cache", max_entries=2)
    c.get("k", lambda: 1)
    st = telemetry.all_stats()
    name = next(n for n in st if n.startswith("unit-test-cache"))
    assert st[name]["programs"] == 1
    assert set(st[name]) == {"programs", "max", "hits", "misses", "evictions"}


# ------------------------------------------------------ memory plan, media

def test_tree_bytes_matches_jax(jax_tiny):
    from vitron_tpu.runtime.memory_plan import tree_bytes as jax_tree_bytes

    _, params, qparams = jax_tiny
    for p in (params, qparams):
        assert tree_bytes(from_jax(p, "cpu")) == jax_tree_bytes(p) > 0


def test_memory_plan_budget_is_the_devices():
    """A CUDA device's budget is its total memory; off the card there is no
    default, and a plan made by hand names its budget."""
    with pytest.raises(ValueError, match="budget_bytes"):
        MemoryPlan.for_device("cpu")
    with pytest.raises(TypeError):
        MemoryPlan()
    if torch.cuda.is_available():
        assert MemoryPlan.for_device("cuda").budget_bytes == \
            torch.cuda.get_device_properties(0).total_memory
    gib = 1024 ** 3
    p = MemoryPlan(budget_bytes=16 * gib)
    assert p.add("llm", 7 * gib) == 7 * gib and p.fits
    p.add("video", 9 * gib)
    assert p.resident_bytes == 16 * gib and not p.fits and "OVER" in p.report()
    with pytest.raises(MemoryError):
        p.add("more", gib, strict=True)


def test_host_pipelines_keep_order():
    """HostPrefetcher and PipelinedRunner yield in input order while the
    prepare calls run in worker threads, like the JAX package's."""
    from vitron_tpu.runtime.pipeline import PipelinedRunner as JaxRunner
    from vitron_tpu_torch.runtime.pipeline import HostPrefetcher, PipelinedRunner

    def slow_square(i):
        time.sleep(0.002 * (7 - i % 7))  # later items finish first
        return i * i

    pre = HostPrefetcher(slow_square, num_workers=4, depth=3)
    runner, jrunner = (cls(slow_square, lambda x: x + 1, num_workers=4, depth=2)
                       for cls in (PipelinedRunner, JaxRunner))
    try:
        assert list(pre.map(range(20))) == [i * i for i in range(20)]
        assert list(runner.run(range(9))) == list(jrunner.run(range(9)))
    finally:
        pre.close()
        runner.close()
        jrunner.close()


def test_serving_pipeline_unbatched(engine):
    """batched=False: one device thread serializes whole chats; the replies
    equal the plain chat's and no batcher is installed."""
    from vitron_tpu_torch.runtime.pipeline import ServingPipeline

    system = VitronSystem(engine, memory_plan=MemoryPlan(budget_bytes=HOST_BUDGET))
    sampling = SamplingConfig(greedy=True, max_new_tokens=6)
    want = [system.chat(f"question {i}", sampling=sampling)["reply"]["raw"] for i in range(3)]
    pipe = ServingPipeline(system, batched=False)
    try:
        assert pipe.batcher is None and engine.batcher is None
        futs = [pipe.submit(f"question {i}", sampling=sampling) for i in range(3)]
        assert [f.result(timeout=WAIT)["reply"]["raw"] for f in futs] == want
    finally:
        pipe.close()


def test_media_prefetcher_matches_jax(tmp_path):
    """The port's MediaPrefetcher (media/preprocess.py's batch resize)
    against the JAX package's (its g++-built resize, or its numpy fallback)
    on the same PNG, at tests/test_native_media.py's 1e-4."""
    from PIL import Image

    from vitron_tpu.runtime.pipeline import MediaPrefetcher as JaxPrefetcher
    from vitron_tpu_torch.runtime.pipeline import MediaPrefetcher

    path = tmp_path / "img.png"
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (96, 128, 3), np.uint8)).save(path)
    port, jaxp = MediaPrefetcher(32, num_workers=2), JaxPrefetcher(32, num_workers=2)
    try:
        got = port.submit("image", str(path)).result(timeout=WAIT)
        want = jaxp.submit("image", str(path)).result(timeout=WAIT)
    finally:
        port.close()
        jaxp.pool.shutdown(wait=False)
    assert tuple(got.shape) == (32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------- serving

def _b64_png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def servers():
    """The port's `--demo` system served on the CPU, beside the JAX
    package's demo system served the same way."""
    import jax

    from vitron_tpu.apps.serve import serve as jax_serve
    from vitron_tpu.models import vitron_model as jvm
    from vitron_tpu.runtime.engine import VitronEngine as JaxEngine
    from vitron_tpu.runtime.system import VitronSystem as JaxSystem
    from vitron_tpu_torch.apps.cli import build_demo_system
    from vitron_tpu_torch.apps.serve import serve

    jcfg = jvm.VitronConfig.tiny()
    jsys = JaxSystem(JaxEngine(jvm.init_params(jax.random.PRNGKey(0), jcfg), jcfg,
                               DemoTokenizer()))
    port = serve(build_demo_system(torch.device("cpu")), host="127.0.0.1", port=0,
                 background=True)
    jsrv = jax_serve(jsys, host="127.0.0.1", port=0, background=True)
    try:
        yield port, jsrv
    finally:
        for s in (port, jsrv):
            s.shutdown()
            s.server_close()
        port.pipeline.close()


def _call(server, path, body=None):
    """-> (HTTP status, JSON or text body)."""
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"} if body else {})
    try:
        with urllib.request.urlopen(req, timeout=WAIT) as r:
            raw, code = r.read(), r.status
    except urllib.error.HTTPError as e:
        raw, code = e.read(), e.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def _both(servers, path, body=None):
    return [_call(s, path, body) for s in servers]


def test_health(servers):
    (code, data), (jcode, jdata) = _both(servers, "/health")
    assert code == jcode == 200
    assert data == jdata == {"status": "ok", "backends": {}}


def test_chat_with_image(servers):
    img = np.random.RandomState(0).randint(0, 255, (40, 40, 3), np.uint8)
    body = json.dumps({"prompt": "what is this?", "image": _b64_png(img), "greedy": True,
                       "max_new_tokens": 4}).encode()
    (code, data), (jcode, jdata) = _both(servers, "/chat", body)
    assert code == jcode == 200
    assert data["status"] == jdata["status"] == "chat"
    assert set(data) == set(jdata) and len(data["raw"]) > 0


def test_bad_path(servers):
    (code, data), (jcode, jdata) = _both(servers, "/nope", b"{}")
    assert code == jcode == 404 and set(data) == set(jdata)
    (code, _), (jcode, _) = _both(servers, "/nope")
    assert code == jcode == 404


def test_malformed_body_returns_500(servers):
    (code, data), (jcode, jdata) = _both(servers, "/chat", b"not json")
    assert code == jcode == 500
    assert set(data) == set(jdata) and "error" in data


def test_stats_reports_memory_plan(servers):
    (code, data), (jcode, jdata) = _both(servers, "/stats")
    assert code == jcode == 200
    assert set(jdata) <= set(data)
    assert data["fits"] is True and "llm+towers" in data["entries"]
    assert "budget" in data["report"]
    assert data["budget_bytes"] == DEMO_HOST_BUDGET  # the CPU demo's plan


def test_ui_page_and_fetch_contract(servers):
    """The browser UI: every element id the page's script reads, and /chat
    taking a text-only body, a region box, and a sketch."""
    port, _ = servers
    code, html = _call(port, "/")
    assert code == 200
    for el in ("log", "prompt", "image", "media", "greedy", "pad"):
        assert f'id="{el}"' in html, el
    assert "<canvas" in html and "async function send" in html
    img = np.random.RandomState(0).randint(0, 255, (48, 40, 3), np.uint8)
    sketch = np.zeros((48, 40, 3), np.uint8)
    sketch[10:30, 8:25] = 255
    bodies = [
        {"prompt": "hello", "greedy": True, "max_new_tokens": 4},
        {"prompt": "this region?", "greedy": True, "image": _b64_png(img),
         "region": [4.5, 5.2, 30.9, 35.1], "max_new_tokens": 4},
        {"prompt": "segment my circle", "greedy": True, "image": _b64_png(img),
         "sketch": _b64_png(sketch), "max_new_tokens": 4},
    ]
    for body in bodies:
        (code, out), (jcode, jout) = _both(servers, "/chat", json.dumps(body).encode())
        assert code == jcode == 200
        assert out.get("status") in ("chat", "ok", "error"), out
        assert "error" not in out or not out["error"], out
        assert set(out) == set(jout)


def test_serve_stats_reports_batching(servers):
    """Four concurrent clients co-batch, and /stats shows the occupancy."""
    port, _ = servers
    before = _call(port, "/stats")[1]["batching"]
    results = [None] * 4

    def post(i):
        results[i] = _call(port, "/chat", json.dumps({
            "prompt": f"client {i} asks", "greedy": True, "max_new_tokens": 8}).encode())

    _run_threads([lambda i=i: post(i) for i in range(4)])
    assert all(r is not None and r[0] == 200 and r[1].get("raw") for r in results), results
    code, stats = _call(port, "/stats")
    b = stats["batching"]
    assert code == 200 and b["admitted"] - before["admitted"] == 4
    assert b["finished"] - before["finished"] == 4
    assert "paged-server-chunk" in " ".join(stats["programs"])


def test_main_runs_on_the_card_unless_asked_for_the_cpu(capsys):
    """`--device` defaults to cuda, which is an error without a card, never
    the CPU; a `--weights` dir that does not exist and a `--base-model`
    that is not a checkpoint dir are refused with the reason."""
    from vitron_tpu_torch.apps import serve as tserve

    assert tserve.main(["--weights", "w", "--device", "cpu"]) == 2
    assert "weights dir w does not exist" in capsys.readouterr().err
    assert tserve.main(["--base-model", "m", "--device", "cpu"]) == 2
    assert "HF llama dir" in capsys.readouterr().err
    if not torch.cuda.is_available():
        assert tserve.main(["--demo", "--port", "0"]) == 2
        assert "no CUDA device" in capsys.readouterr().err


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the decode chunks replay CUDA graphs only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_replayed_chunks_match_eager_on_the_card(cuda, monkeypatch):
    """On the card every decode chunk is a captured graph: generate_scan,
    a sampled Generator request over three chunks and a mixed PagedServer
    chunk give the same tokens as the same steps run eagerly (the graph
    launches the same kernels in the same order), and each replay counts
    the int4 launches its graph recorded."""
    from vitron_tpu_torch.kernels import int4_matmul
    from vitron_tpu_torch.kernels.quantization import quantize_llama
    from vitron_tpu_torch.models.llm.paged_cache import PagedServer
    from vitron_tpu_torch.runtime import graphs

    cfg = tvm.VitronConfig.tiny(llm=tl.LlamaConfig.tiny(
        hidden_size=256, intermediate_size=512, num_heads=4, num_kv_heads=4,
        attn_impl="flash"))
    params = tvm.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, cuda)
    params["llm"] = quantize_llama(params["llm"], bits=4, head=True)
    plan, px = _plan()
    images = torch.from_numpy(px).to(cuda)
    hot = SamplingConfig(temperature=1.0, top_p=0.9, max_new_tokens=12, eos_ids=())

    def run():
        g = tgen.Generator(params, cfg)
        scan = tgen.generate_scan(params, cfg, _arrays(plan), 12, images=images,
                                  generator=g).tolist()
        sampled = g.generate(plan, images=images, sampling=hot, decode_chunk=5,
                             gen=torch.Generator(device=cuda).manual_seed(1))[0]
        srv = PagedServer(params["llm"], cfg.llm, num_blocks=32, block_size=4)
        sids = [srv.add_request([5, 17, 3, 99, 42]), srv.add_request([7, 8])]
        u = torch.rand((6, 2), generator=torch.Generator(device=cuda).manual_seed(2),
                       device=cuda)
        out = srv.step_n(6, sampling={sids[0]: (1.0, 0.9, False), sids[1]: (0.0, 1.0, True),
                                      "uniforms": u})
        torch.cuda.synchronize()
        return scan, sampled, out, g

    graphs.replayed.clear()
    *got, g = run()
    replays = graphs.replayed[("int4_matmul", "launches")]
    per_step = 7 * cfg.llm.num_layers + 1
    # generate_scan: 11 steps; the sampled request: 3 chunks of 5; step_n: 6 steps
    assert replays == per_step * (11 + 3 * 5 + 6), replays
    assert g.last_chunk.run.graph is not None
    before = int4_matmul.launches
    monkeypatch.setattr(graphs.Chunk, "__call__", lambda self: self.body())
    *want, _ = run()
    assert got == want
    assert int4_matmul.launches - before > replays  # eagerly, the wrappers launch them
