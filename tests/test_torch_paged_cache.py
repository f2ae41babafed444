"""The port's paged KV cache (`models/llm/paged_cache.py`) against the JAX
package's on the CPU.

Each case of the JAX package's tests/test_paged_cache.py runs on both
packages with the same `LlamaConfig.tiny()` parameters (made by the JAX
package's `init_params`, carried across with `from_jax`): greedy tokens
identical to JAX's `PagedServer` and to the dense cache, blocks recycled,
the table growing past `max_blocks`, pool exhaustion raising, and the int4
head. Then the port's own parts: the in-place pool, `write_tokens`, and
`sample_token_batched` (greedy rows, the inverse CDF, the top-p cut).
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.llm import llama as tl
from vitron_tpu_torch.models.llm import paged_cache as tp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def tiny():
    """(JAX params, port config, port params) of LlamaConfig.tiny()."""
    import jax

    from vitron_tpu.models.llm import llama as jl

    jp = jl.init_params(jax.random.PRNGKey(0), jl.LlamaConfig.tiny())
    return jp, tl.LlamaConfig.tiny(), from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _jax_server(jp, **kw):
    from vitron_tpu.models.llm import llama as jl
    from vitron_tpu.models.llm.paged_cache import PagedServer

    return PagedServer(jp, jl.LlamaConfig.tiny(), **kw)


def _dense_greedy(cfg, params, prompt, n):
    """Dense-cache greedy continuation (the port's host-index path)."""
    cache = tl.KVCache.create(cfg, 1, max_len=64)
    logits, _ = tl.forward_tokens(params, cfg, torch.tensor([prompt]),
                                  positions=torch.arange(len(prompt))[None], cache=cache)
    out = [int(torch.argmax(logits[0, -1]))]
    for i in range(n - 1):
        logits, _ = tl.forward_tokens(params, cfg, torch.tensor([[out[-1]]]),
                                      positions=torch.tensor([[len(prompt) + i]]), cache=cache)
        out.append(int(torch.argmax(logits[0, -1])))
    return out


def test_paged_matches_dense_greedy(tiny):
    """Greedy continuation through the paged server == dense-cache greedy
    == JAX's paged server (block_size 4 forces multi-block tables)."""
    jp, cfg, params = tiny
    prompt = [5, 17, 3, 99, 42]
    srv = tp.PagedServer(params, cfg, num_blocks=32, block_size=4)
    sid = srv.add_request(prompt)
    got = [srv.step()[sid] for _ in range(6)]
    jsrv = _jax_server(jp, num_blocks=32, block_size=4)
    jsid = jsrv.add_request(prompt)
    want = [jsrv.step()[jsid] for _ in range(6)]
    assert got == want == _dense_greedy(cfg, params, prompt, 6)


def test_two_sequences_isolated(tiny):
    """Interleaved sequences decode identically to each alone, and as JAX's."""
    jp, cfg, params = tiny
    pa, pb = [5, 17, 3], [100, 42, 7, 9]

    def alone(prompt, n=4):
        srv = tp.PagedServer(params, cfg, num_blocks=32, block_size=4)
        sid = srv.add_request(prompt)
        return [srv.step()[sid] for _ in range(n)]

    srv = tp.PagedServer(params, cfg, num_blocks=64, block_size=4)
    jsrv = _jax_server(jp, num_blocks=64, block_size=4)
    sa, sb = srv.add_request(pa), srv.add_request(pb)
    ja, jb = jsrv.add_request(pa), jsrv.add_request(pb)
    got_a, got_b, want_a, want_b = [], [], [], []
    for _ in range(4):
        out, jout = srv.step(), jsrv.step()
        got_a.append(out[sa])
        got_b.append(out[sb])
        want_a.append(jout[ja])
        want_b.append(jout[jb])
    assert got_a == want_a == alone(pa)
    assert got_b == want_b == alone(pb)


def test_blocks_recycled(tiny):
    _, cfg, params = tiny
    srv = tp.PagedServer(params, cfg, num_blocks=8, block_size=4)
    free0 = len(srv.pool.free)
    sid = srv.add_request([1, 2, 3, 4, 5])
    assert len(srv.pool.free) < free0
    srv.finish(sid)
    assert len(srv.pool.free) == free0


def test_table_grows_past_max_blocks(tiny):
    """Sequences longer than max_blocks_per_seq*block_size keep full
    attention: the table doubles instead of truncating."""
    jp, cfg, params = tiny
    prompt = [5, 17, 3, 99, 42, 8, 11, 2]
    n_steps = 12  # 8 prompt + 12 decode = 20 tokens > 2 blocks * 4
    srv = tp.PagedServer(params, cfg, num_blocks=32, block_size=4, max_blocks_per_seq=2)
    sid = srv.add_request(prompt)
    got = [srv.step()[sid] for _ in range(n_steps)]
    jsrv = _jax_server(jp, num_blocks=32, block_size=4, max_blocks_per_seq=2)
    jsid = jsrv.add_request(prompt)
    want = [jsrv.step()[jsid] for _ in range(n_steps)]
    assert srv.max_blocks >= 5 and srv.max_blocks == jsrv.max_blocks
    assert got == want == _dense_greedy(cfg, params, prompt, n_steps)


def test_step_n_chunked_matches_dense(tiny):
    """step_n (the n-step chunk a CUDA graph captures on the card, eager
    here) reproduces dense-cache greedy and JAX's step_n, 16/16 tokens,
    across a block boundary and a table growth."""
    jp, cfg, params = tiny
    prompt, n = [5, 17, 3, 99, 42], 16
    srv = tp.PagedServer(params, cfg, num_blocks=32, block_size=4, max_blocks_per_seq=2)
    sid = srv.add_request(prompt)
    got = [srv.step()[sid]] + srv.step_n(n - 1)[sid]
    jsrv = _jax_server(jp, num_blocks=32, block_size=4, max_blocks_per_seq=2)
    jsid = jsrv.add_request(prompt)
    want = [jsrv.step()[jsid]] + jsrv.step_n(n - 1)[jsid]
    assert got == want == _dense_greedy(cfg, params, prompt, n)


def test_step_n_two_sequences(tiny):
    """Chunked decode over a ragged batch stays isolated per sequence."""
    jp, cfg, params = tiny
    pa, pb = [5, 17, 3], [100, 42, 7, 9]

    def alone(prompt, n=6):
        srv = tp.PagedServer(params, cfg, num_blocks=32, block_size=4)
        sid = srv.add_request(prompt)
        return [srv.step()[sid]] + srv.step_n(n - 1)[sid]

    srv = tp.PagedServer(params, cfg, num_blocks=64, block_size=4)
    sa, sb = srv.add_request(pa), srv.add_request(pb)
    firsts, chunk = srv.step(), srv.step_n(5)
    jsrv = _jax_server(jp, num_blocks=64, block_size=4)
    ja, jb = jsrv.add_request(pa), jsrv.add_request(pb)
    jfirsts, jchunk = jsrv.step(), jsrv.step_n(5)
    assert [firsts[sa]] + chunk[sa] == [jfirsts[ja]] + jchunk[ja] == alone(pa)
    assert [firsts[sb]] + chunk[sb] == [jfirsts[jb]] + jchunk[jb] == alone(pb)


def test_pool_exhaustion_raises(tiny):
    jp, cfg, params = tiny
    srv = tp.PagedServer(params, cfg, num_blocks=2, block_size=4)
    with pytest.raises(RuntimeError, match="exhausted"):
        srv.add_request(list(range(1, 20)))
    with pytest.raises(RuntimeError, match="exhausted"):
        _jax_server(jp, num_blocks=2, block_size=4).add_request(list(range(1, 20)))


def test_paged_decode_with_quantized_head(tiny):
    """Packed-int4 projections and lm_head ({"q4","s"}, the serving
    default) through step_n: the int4 matmul (B1's plain version here) at
    M = the active batch; tokens equal JAX's on the same packed weights."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.kernels.quantization import quantize_llama

    jp, cfg, _ = tiny
    jq = quantize_llama(jp, bits=4, head=True)
    qp = from_jax(jax.tree.map(np.asarray, jq), "cpu")
    assert isinstance(qp["lm_head"], dict) and qp["lm_head"]["q4"].dim() == 2
    srv = tp.PagedServer(qp, cfg, num_blocks=32, block_size=4)
    sid = srv.add_request([5, 17, 3, 99, 42])
    out = srv.step_n(4)
    jsrv = _jax_server(jax.tree.map(jnp.asarray, jq), num_blocks=32, block_size=4)
    jsid = jsrv.add_request([5, 17, 3, 99, 42])
    assert out[sid] == jsrv.step_n(4)[jsid]
    assert len(out[sid]) == 4 and all(isinstance(t, int) for t in out[sid])


def test_pool_is_updated_in_place(tiny):
    """Every write goes into the pool's own tensors (a captured graph reads
    their addresses), and the chunk's mirror of each new token equals what
    `step` writes."""
    _, cfg, params = tiny
    srv = tp.PagedServer(params, cfg, num_blocks=16, block_size=4)
    ptrs = (srv.pool.k.data_ptr(), srv.pool.v.data_ptr())
    sid = srv.add_request([5, 17, 3, 99, 42])
    srv.step_n(3)
    other = tp.PagedServer(params, cfg, num_blocks=16, block_size=4)
    oid = other.add_request([5, 17, 3, 99, 42])
    for _ in range(3):
        other.step()
    assert (srv.pool.k.data_ptr(), srv.pool.v.data_ptr()) == ptrs
    assert srv.seqs[sid].blocks == other.seqs[oid].blocks
    blocks = torch.tensor(srv.seqs[sid].blocks)
    torch.testing.assert_close(srv.pool.k[:, blocks].reshape(cfg.num_layers, -1, 4, 16)[:, :7],
                               other.pool.k[:, blocks].reshape(cfg.num_layers, -1, 4, 16)[:, :7],
                               rtol=1e-5, atol=1e-5)


def test_write_tokens_unaligned(tiny):
    """The general append path splits a write across block boundaries."""
    _, cfg, _ = tiny
    pool = tp.PagedPool.create(cfg, num_blocks=8, block_size=4)
    seq = tp.PagedSequence(blocks=[])
    g = torch.Generator().manual_seed(0)
    k = torch.randn((cfg.num_layers, 6, cfg.num_kv_heads, cfg.head_dim), generator=g)
    tp.write_tokens(pool, seq, k[:, :3], k[:, :3] * 2)
    assert tp.write_tokens(pool, seq, k[:, 3:], k[:, 3:] * 2) is pool
    assert seq.length == 6 and len(seq.blocks) == 2
    table = torch.tensor([seq.blocks])
    got_k, got_v = tp.gather_kv(pool, table)
    torch.testing.assert_close(got_k[:, 0, :6], k)
    torch.testing.assert_close(got_v[:, 0, :6], k * 2)


def test_sample_token_batched():
    """Greedy rows take the argmax; a sampled row takes the token whose
    cumulative probability first passes its uniform; top_p cuts the tail
    (the top-1 token always kept)."""
    logits = torch.log(torch.tensor([[0.1, 0.6, 0.3, 0.0001]] * 3))
    temps = torch.tensor([1.0, 1.0, 1.0])
    top_ps = torch.tensor([1.0, 1.0, 0.5])
    greedy = torch.tensor([True, False, False])
    probs = torch.softmax(logits[0], -1)
    cdf = torch.cumsum(probs, -1)
    for u, want in ((0.05, 0), (float(cdf[0]) + 1e-3, 1), (0.95, 2), (0.99995, 3)):
        got = tp.sample_token_batched(logits, temps, top_ps, greedy, torch.full((3,), u))
        assert got.tolist() == [1, want, 1], (u, got)
    # temperature 0 is greedy too
    got = tp.sample_token_batched(logits, torch.tensor([0.0, 0.0, 0.0]), top_ps,
                                  torch.zeros(3, dtype=torch.bool), torch.full((3,), 0.99))
    assert got.tolist() == [1, 1, 1]
    # frequencies over a grid of uniforms follow the (temperature-scaled) probabilities
    u = (torch.arange(10000) + 0.5) / 10000
    rows = logits[:1].expand(10000, -1)
    got = tp.sample_token_batched(rows, torch.full((10000,), 0.5), torch.ones(10000),
                                  torch.zeros(10000, dtype=torch.bool), u)
    want = torch.softmax(logits[0] / 0.5, -1)
    np.testing.assert_allclose(torch.bincount(got, minlength=4).numpy() / 10000, want.numpy(),
                               atol=2e-4)


def test_sample_token_batched_top_p_matches_jax():
    """Both packages sample inside the same top-p support: the tokens whose
    temperature-scaled logit reaches the cutoff (the first sorted logit
    where the cumulative probability reaches top_p)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.llm.paged_cache import sample_token_batched as jax_sample

    rs = np.random.RandomState(0)
    logits = rs.randn(4, 50).astype(np.float32) * 3
    temps = np.asarray([0.7, 1.0, 1.3, 0.9], np.float32)
    top_ps = np.asarray([0.5, 0.9, 0.3, 1.0], np.float32)
    greedy = np.zeros(4, bool)
    support = []
    for r in range(4):
        scaled = logits[r] / temps[r]
        srt = np.sort(scaled)[::-1]
        cum = np.cumsum(np.exp(srt - srt.max()) / np.exp(srt - srt.max()).sum())
        cut = srt[min(int((cum < top_ps[r]).sum()), len(srt) - 1)]
        support.append(set(np.nonzero(scaled >= cut)[0].tolist()))
    u = torch.from_numpy(rs.rand(400, 4).astype(np.float32))
    args = [torch.from_numpy(a) for a in (logits, temps, top_ps, greedy)]
    port = np.stack([tp.sample_token_batched(*args, u[i]).numpy() for i in range(400)])
    draws = np.stack([np.asarray(jax_sample(key, *map(jnp.asarray, (logits, temps, top_ps,
                                                                     greedy))))
                      for key in jax.random.split(jax.random.PRNGKey(0), 400)])
    for r in range(4):
        assert set(port[:, r].tolist()) <= support[r], r
        assert set(draws[:, r].tolist()) <= support[r], r
    assert len(support[2]) < len(support[3]) == 50  # the cut is real; top_p 1 keeps all
