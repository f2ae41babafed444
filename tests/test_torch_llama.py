"""Parity of the port's Llama decoder with the JAX package on the CPU.

The JAX params are made by `vitron_tpu.models.llm.llama.init_params` and
carried across with `from_jax`; token ids come from a seeded RandomState.
Float32 tolerance rtol=atol=1e-4 unless stated.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import quantization as tq
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.llm import llama as tl

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    """(JAX llama module, JAX config, JAX params with numpy leaves)."""
    import jax

    from vitron_tpu.models.llm import llama as jl

    cfg = jl.LlamaConfig.tiny(num_kv_heads=2)
    params = jax.tree.map(np.asarray, jl.init_params(jax.random.PRNGKey(0), cfg))
    return jl, cfg, params


def _port_cfg(jcfg, **kw):
    return tl.LlamaConfig.tiny(num_kv_heads=jcfg.num_kv_heads, **kw)


def _ids(cfg, b=2, s=12, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_logits(jl, jcfg, params, ids, mask=None):
    import jax
    import jax.numpy as jnp

    pos = np.broadcast_to(np.arange(ids.shape[1]), ids.shape).astype(np.int32)
    logits, _ = jl.forward_tokens(jax.tree.map(jnp.asarray, params), jcfg, jnp.asarray(ids),
                                  positions=jnp.asarray(pos),
                                  attn_mask=None if mask is None else jnp.asarray(mask))
    return np.asarray(logits)


def _port_logits(cfg, params, ids, mask=None, cache=None):
    pos = torch.from_numpy(np.broadcast_to(np.arange(ids.shape[1]), ids.shape).copy())
    logits, _ = tl.forward_tokens(params, cfg, torch.from_numpy(ids).long(), positions=pos,
                                  attn_mask=None if mask is None else torch.from_numpy(mask),
                                  cache=cache)
    return logits.numpy()


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_tiny_logits_match_jax(tiny, attn_impl):
    jl, jcfg, params = tiny
    ids = _ids(jcfg)
    mask = np.ones(ids.shape, bool)
    mask[1, 9:] = False  # right padding on one row
    want = _jax_logits(jl, jcfg, params, ids, mask)
    got = _port_logits(_port_cfg(jcfg, attn_impl=attn_impl), from_jax(params, "cpu"), ids,
                       mask)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1, :9], want[1, :9], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_chunked_prefill_matches_full(tiny, attn_impl):
    """Prefill 8 tokens through the cache, then decode 4 singles == one
    uncached forward (as tests/test_llama.py holds the JAX package)."""
    _, jcfg, params = tiny
    cfg = _port_cfg(jcfg, attn_impl=attn_impl)
    p = from_jax(params, "cpu")
    ids = _ids(jcfg)
    full = _port_logits(cfg, p, ids)
    cache = tl.KVCache.create(cfg, 2, max_len=32)
    outs = [_port_logits(cfg, p, ids[:, :8], cache=cache)]
    for i in range(8, 12):
        pos = torch.full((2, 1), i, dtype=torch.long)
        li, _ = tl.forward_tokens(p, cfg, torch.from_numpy(ids[:, i:i + 1]).long(),
                                  positions=pos, cache=cache)
        outs.append(li.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full, rtol=2e-4, atol=2e-4)
    assert cache.index == 12


def test_cached_chunks_match_jax(tiny):
    """Two cached prefill chunks (the flash kernel's q_offset path) against
    the JAX package's cached forward."""
    import jax
    import jax.numpy as jnp

    jl, jcfg, params = tiny
    ids = _ids(jcfg, s=10, seed=2)
    pos = np.broadcast_to(np.arange(10), ids.shape).astype(np.int32)
    jcache = jl.KVCache.create(jcfg, 2, max_len=16)
    jp = jax.tree.map(jnp.asarray, params)
    cfg = _port_cfg(jcfg, attn_impl="flash")
    p = from_jax(params, "cpu")
    cache = tl.KVCache.create(cfg, 2, max_len=16)
    for a, b in ((0, 6), (6, 10)):
        want, jcache = jl.forward_tokens(jp, jcfg, jnp.asarray(ids[:, a:b]),
                                         positions=jnp.asarray(pos[:, a:b]), cache=jcache)
        got, _ = tl.forward_tokens(p, cfg, torch.from_numpy(ids[:, a:b]).long(),
                                   positions=torch.from_numpy(pos[:, a:b].copy()).long(),
                                   cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_logits_match_jax(tiny, bits):
    import jax
    import jax.numpy as jnp

    from vitron_tpu.kernels.quantization import quantize_llama

    jl, jcfg, params = tiny
    qparams = jax.tree.map(np.asarray, quantize_llama(jax.tree.map(jnp.asarray, params),
                                                      bits=bits, head=True))
    ids = _ids(jcfg, seed=3)
    want = _jax_logits(jl, jcfg, qparams, ids)
    got = _port_logits(_port_cfg(jcfg), from_jax(qparams, "cpu"), ids)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # quantizing on the port's side gives the same packed weights
    ported = tq.quantize_llama(from_jax(params, "cpu"), bits=bits, head=True)
    got2 = _port_logits(_port_cfg(jcfg), ported, ids)
    np.testing.assert_allclose(got2, want, rtol=RTOL, atol=ATOL)


def test_flash_equals_xla_on_cpu(tiny):
    _, jcfg, params = tiny
    p = tq.quantize_llama(from_jax(params, "cpu"), bits=4, head=True)
    ids = _ids(jcfg, seed=4)
    mask = np.ones(ids.shape, bool)
    mask[0, 10:] = False
    xla = _port_logits(_port_cfg(jcfg, attn_impl="xla"), p, ids, mask)
    flash = _port_logits(_port_cfg(jcfg, attn_impl="flash"), p, ids, mask)
    np.testing.assert_allclose(flash[0, :10], xla[0, :10], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(flash[1], xla[1], rtol=RTOL, atol=ATOL)


def test_rms_norm_rounds_like_jax():
    import jax.numpy as jnp

    from vitron_tpu.models.llm.llama import rms_norm

    rs = np.random.RandomState(5)
    x = rs.randn(3, 64).astype(np.float32) * 3
    w = rs.rand(64).astype(np.float32)
    want = np.asarray(rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                               1e-5).astype(jnp.float32))
    got = tl.rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), 1e-5)
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_ring_not_ported():
    with pytest.raises(NotImplementedError, match="A16"):
        tl.LlamaConfig.tiny(attn_impl="ring")
    assert dataclasses.replace(tl.LlamaConfig.vicuna_7b(), attn_impl="flash").head_dim == 128
