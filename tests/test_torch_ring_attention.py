"""The port's ring attention (`distributed/ring_attention.py`) on 2 and 4
gloo ranks against the JAX package's `ring_attention` over its 8-device
virtual context axis (tests/conftest.py) and against full attention:

- causal and non-causal, GQA (4 query heads on 2 KV heads: the port rotates
  the KV heads and the block takes the GQA, JAX's ring is given the heads
  repeated);
- the tiny llama's prefill with attn_impl="ring" (GQA too) against JAX's
  ring forward and the dense logits.

Tolerance: 2e-4 absolute and relative, float32, as JAX's own
tests/test_ring_attention.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitron_tpu.core.mesh import create_mesh
from vitron_tpu.distributed.ring_attention import ring_attention
from vitron_tpu.models.llm import llama as jl

import torch_dist
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 2e-4
LLAMA_KW = dict(max_seq_len=128, num_kv_heads=2)


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    b, s, n, kv, d = 2, 64, 4, 2, 16
    q = rs.randn(b, s, n, d).astype(np.float32)
    k = rs.randn(b, s, kv, d).astype(np.float32)
    v = rs.randn(b, s, kv, d).astype(np.float32)
    cfg = jl.LlamaConfig.tiny(**LLAMA_KW)
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), cfg))
    ids = rs.randint(1, cfg.vocab_size, (2, 64)).astype(np.int64)
    ctx = create_mesh({"context": 8})
    rep = lambda a: jnp.repeat(jnp.asarray(a), n // kv, axis=2)  # noqa: E731
    want = {c: np.asarray(ring_attention(jnp.asarray(q), rep(k), rep(v), ctx, causal=c))
            for c in (True, False)}
    pos = jnp.broadcast_to(jnp.arange(64), (2, 64))
    jring, _ = jl.forward_tokens(jax.tree.map(jnp.asarray, params),
                                 jl.LlamaConfig.tiny(attn_impl="ring", **LLAMA_KW),
                                 jnp.asarray(ids), positions=pos, mesh=ctx)
    jdense, _ = jl.forward_tokens(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(ids),
                                  positions=pos)
    return (q, k, v), params, ids, want, np.asarray(jring), np.asarray(jdense)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    (q, k, v), params, ids, *_ = inputs
    return {n: torch_dist.run(n, "torch_mesh_bodies:ring_checks", q, k, v, (True, False),
                              params, LLAMA_KW, ids, tmp=tmp_path_factory.mktemp(f"ring{n}"))
            for n in (2, 4)}


def _dense(q, k, v, causal):
    g = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
    logits = np.einsum("bqnd,bknd->bnqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        s = q.shape[1]
        logits = np.where(np.tril(np.ones((s, s), bool)), logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return np.einsum("bnqk,bknd->bqnd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_and_full(inputs, ranks, n, causal):
    (q, k, v), _, _, want, _, _ = inputs
    full = _dense(q, k, v, causal)
    for outs, _, _ in ranks[n]:
        got = outs[0 if causal else 1]
        np.testing.assert_allclose(got, want[causal], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_llama_ring_forward_matches_jax_and_dense(inputs, ranks, n):
    *_, jring, jdense = inputs
    for _, ring, dense in ranks[n]:
        np.testing.assert_allclose(ring, jring, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(ring, dense, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(dense, jdense, rtol=TOL, atol=TOL)
    assert all(np.array_equal(r[1], ranks[n][0][1]) for r in ranks[n])  # every rank the same
