"""Parity of the port's MPT decoder with the JAX package on the CPU.

The JAX params come from `vitron_tpu.models.llm.mpt.init_params` and are
carried across with `from_jax`; token ids come from a seeded RandomState.
Float32 tolerance rtol=atol=1e-4 (the two packages sum the same float32
products in other orders), unless stated.
"""
import dataclasses

import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.llm import mpt as tm
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = ATOL = 1e-4


@pytest.fixture(scope="module")
def jm():
    from vitron_tpu.models.llm import mpt

    return mpt


def _params(jm, jcfg, seed=0):
    import jax

    return jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(seed), jcfg))


def _port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
          if f.name not in ("param_dtype", "compute_dtype")}
    return tm.MPTConfig.tiny(**kw)


def _ids(vocab, b=2, s=12, seed=1):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def _jax_cache(jm, jcfg, b, t):
    """JAX's llama.KVCache at MPT's heads (as its own cache test builds it)."""
    from vitron_tpu.models.llm.llama import KVCache

    fake = dataclasses.make_dataclass(
        "C", ["num_layers", "num_kv_heads", "head_dim", "compute_dtype", "max_seq_len"])(
        jcfg.n_layers, jcfg.n_heads, jcfg.head_dim, jcfg.compute_dtype, t)
    return KVCache.create(fake, b, max_len=t)


@pytest.mark.parametrize("n_heads", [4, 6, 32])
def test_alibi_slopes_match_jax(jm, n_heads):
    """Powers of two and the odd-head padding (6 heads: slopes of 8, odd ones first)."""
    np.testing.assert_array_equal(tm.gen_alibi_slopes(n_heads, 8.0),
                                  jm.gen_alibi_slopes(n_heads, 8.0))


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("n_heads", [4, 6])
def test_alibi_bias_matches_jax(jm, full, n_heads):
    """Both forms, at query rows offset into a longer key range (slot space)."""
    import jax.numpy as jnp

    q, k = np.arange(5, 12), np.arange(16)
    want = np.asarray(jm.alibi_bias(n_heads, jnp.asarray(q), jnp.asarray(k), 8.0, full=full))
    got = tm.alibi_bias(n_heads, torch.from_numpy(q), torch.from_numpy(k), 8.0, full=full)
    np.testing.assert_array_equal(got.numpy(), want)


def _both(jm, jcfg, params, ids, **kw):
    import jax.numpy as jnp

    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    want = np.asarray(jm.forward(_jtree(params), jcfg, jnp.asarray(ids), **jkw))
    tkw = {k: torch.from_numpy(np.array(v)) for k, v in kw.items()}
    got = tm.forward(from_jax(params, "cpu"), _port_cfg(jcfg),
                     torch.from_numpy(ids).long(), **tkw)
    return got.numpy(), want


def _jtree(params):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, params)


@pytest.mark.parametrize("variant", ["causal", "prefix_lm", "learned_pos"])
def test_forward_matches_jax(jm, variant):
    """Causal prefill, the prefix-LM mask (the first 5 positions of row 0
    and 3 of row 1 bidirectional, with the symmetric bias) and
    alibi=False with learned positional embeddings."""
    kw = {}
    if variant == "learned_pos":
        jcfg = jm.MPTConfig.tiny(alibi=False, learned_pos_emb=True)
    else:
        jcfg = jm.MPTConfig.tiny()
    params = _params(jm, jcfg)
    assert ("wpe" in params) == (variant == "learned_pos")
    ids = _ids(jcfg.vocab_size)
    if variant == "prefix_lm":
        pm = np.zeros(ids.shape, bool)
        pm[0, :5] = True
        pm[1, :3] = True
        kw["prefix_mask"] = pm
    got, want = _both(jm, jcfg, params, ids, **kw)
    assert got.shape == (2, 12, jcfg.vocab_size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_prefix_mask_changes_the_prompt_rows(jm):
    """The prefix-LM path is not the causal one: the prompt's first
    position sees the later prompt positions."""
    jcfg = jm.MPTConfig.tiny()
    cfg = _port_cfg(jcfg)
    params = from_jax(_params(jm, jcfg), "cpu")
    ids = torch.from_numpy(_ids(jcfg.vocab_size)).long()
    pm = torch.zeros(ids.shape, dtype=torch.bool)
    pm[:, :6] = True
    causal = tm.forward(params, cfg, ids)
    prefix = tm.forward(params, cfg, ids, prefix_mask=pm)
    assert not torch.allclose(causal[:, 0], prefix[:, 0], atol=1e-3)


def test_cached_decode_matches_jax_and_the_full_forward(jm):
    """A cached prefill of 8 tokens, then single-token steps, against JAX's
    cached path step by step and against the uncached forward."""
    import jax.numpy as jnp

    jcfg = jm.MPTConfig.tiny()
    cfg = _port_cfg(jcfg)
    np_params = _params(jm, jcfg)
    jparams, params = _jtree(np_params), from_jax(np_params, "cpu")
    ids = _ids(jcfg.vocab_size, s=13)
    full = tm.forward(params, cfg, torch.from_numpy(ids).long()).numpy()
    jcache = _jax_cache(jm, jcfg, 2, 32)
    cache = tm.kv_cache(cfg, 2, 32)
    pieces = [(0, 8)] + [(i, i + 1) for i in range(8, 13)]
    outs = []
    for a, b in pieces:
        want, jcache = jm.forward(jparams, jcfg, jnp.asarray(ids[:, a:b]), cache=jcache)
        got, cache = tm.forward(params, cfg, torch.from_numpy(ids[:, a:b]).long(), cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        assert cache.index == b
        outs.append(got.numpy())
    np.testing.assert_allclose(np.concatenate(outs, axis=1), full, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=RTOL, atol=ATOL)
    assert cache.valid[:, :13].all() and not cache.valid[:, 13:].any()


def test_greedy_stream_matches_jax(jm):
    """16 greedy tokens through the cache: identical token ids."""
    import jax.numpy as jnp

    jcfg = jm.MPTConfig.tiny()
    cfg = _port_cfg(jcfg)
    np_params = _params(jm, jcfg, seed=3)
    jparams, params = _jtree(np_params), from_jax(np_params, "cpu")
    prompt = _ids(jcfg.vocab_size, b=1, s=6, seed=4)

    jcache = _jax_cache(jm, jcfg, 1, 32)
    logits, jcache = jm.forward(jparams, jcfg, jnp.asarray(prompt), cache=jcache)
    want = []
    for _ in range(16):
        tok = int(np.argmax(np.asarray(logits)[0, -1]))
        want.append(tok)
        logits, jcache = jm.forward(jparams, jcfg, jnp.asarray([[tok]]), cache=jcache)

    cache = tm.kv_cache(cfg, 1, 32)
    logits, cache = tm.forward(params, cfg, torch.from_numpy(prompt).long(), cache=cache)
    got = []
    for _ in range(16):
        tok = int(torch.argmax(logits[0, -1]))
        got.append(tok)
        logits, cache = tm.forward(params, cfg, torch.tensor([[tok]]), cache=cache)
    assert got == want


def test_init_params_tree_matches_jax(jm):
    """The same key paths, shapes and dtypes as JAX's init (wpe only with
    learned positions and no ALiBi), and the JAX init's scales."""
    for kw in ({}, {"alibi": False, "learned_pos_emb": True}):
        jcfg = jm.MPTConfig.tiny(**kw)
        want = _params(jm, jcfg)
        got = tm.init_params(torch.Generator().manual_seed(0), _port_cfg(jcfg), "cpu")
        assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
        for name, w in want["layers"].items():
            assert tuple(got["layers"][name].shape) == w.shape
            assert got["layers"][name].dtype == torch.float32
        std = float(got["layers"]["up"].std())
        assert abs(std - 1 / np.sqrt(jcfg.d_model)) < 0.1 / np.sqrt(jcfg.d_model)


def _reference_state_dict(np_params, cfg, prefix: bool, wpe: bool):
    """The reference's MPT keys, (out, in) weights, from a JAX-layout tree."""
    pfx = "transformer." if prefix else ""
    lay = np_params["layers"]
    sd = {pfx + "wte.weight": torch.from_numpy(np_params["wte"].copy()),
          pfx + "norm_f.weight": torch.from_numpy(np_params["norm_f"].copy())}
    names = {"ln1": "norm_1.weight", "ln2": "norm_2.weight", "wqkv": "attn.Wqkv.weight",
             "wo": "attn.out_proj.weight", "up": "ffn.up_proj.weight",
             "down": "ffn.down_proj.weight"}
    for i in range(cfg.n_layers):
        for k, name in names.items():
            w = lay[k][i]
            sd[f"{pfx}blocks.{i}.{name}"] = torch.from_numpy(np.array(w.T if w.ndim == 2 else w))
    if wpe:
        sd[pfx + "wpe.weight"] = torch.from_numpy(
            np.random.RandomState(5).randn(cfg.max_seq_len, cfg.d_model).astype(np.float32))
    return sd


@pytest.mark.parametrize("prefix", [False, True])
@pytest.mark.parametrize("wpe", [False, True])
def test_convert_hf_mpt_bit_equal_to_jax(jm, prefix, wpe):
    import jax

    jcfg = jm.MPTConfig.tiny()
    sd = _reference_state_dict(_params(jm, jcfg), jcfg, prefix, wpe)
    want = jax.tree.map(np.asarray, jm.convert_hf_mpt(sd, jcfg))
    got = tm.convert_hf_mpt(sd, _port_cfg(jcfg))
    assert ("wpe" in got) == wpe == ("wpe" in want)
    for k in ("wte", "norm_f") + (("wpe",) if wpe else ()):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    for k, w in want["layers"].items():
        assert got["layers"][k].is_contiguous()
        np.testing.assert_array_equal(got["layers"][k].numpy(), w)
