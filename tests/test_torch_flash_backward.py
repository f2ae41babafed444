"""Parity of the port's flash-attention LSE and backward with the JAX Pallas
kernels (run in interpret mode, as the JAX package's own tests run them on
the CPU), and of the hand CUDA kernels B2-with-LSE, B5a and B5b with their
plain versions (on a card).

Every case gives both packages the same numpy inputs from a seeded
RandomState. Errors are max |port - JAX| / max |JAX| per output: 1e-5 in
float32 (only the order of float32 sums differs) and 2e-2 in bfloat16
(both sides round q * scale, p and ds to bfloat16, but at other sums).
JAX is imported inside the parity tests, so the `cuda` tests also run where
JAX is not installed.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# name: (S, T, N, KH, D, q_offset, causal, valid slots (None = no mask), shift)
CASES = {
    "causal": (16, 16, 4, 4, 16, 0, True, None, None),
    "q_offset_kv_mask": (8, 24, 4, 4, 16, 12, True, [0, 1, 2, 5, 6, 9, 10, 11, 12, 15, 20], None),
    "gqa": (16, 24, 4, 2, 16, 8, True, None, None),
    "ragged": (11, 19, 2, 2, 16, 8, True, list(range(17)), None),
    "non_causal": (12, 20, 2, 1, 16, 0, False, list(range(3, 17)), None),
    "no_visible_key": (8, 16, 2, 2, 16, 0, True, list(range(4, 16)), None),
    "softmax_shift": (16, 16, 2, 2, 16, 0, True, None, 4.0),
}
DTYPES = ["float32", "bfloat16"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


def _inputs(s, t, n, kh, d, valid, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(2, s, n, d).astype(np.float32)
    k = rs.randn(2, t, kh, d).astype(np.float32)
    v = rs.randn(2, t, kh, d).astype(np.float32)
    g = rs.randn(2, s, n, d).astype(np.float32)
    mask = None
    if valid is not None:
        mask = np.zeros((2, t), bool)
        mask[:, valid] = True
        mask[1, valid[-1]] = False  # the rows differ
    return q, k, v, g, mask


def _torch(a, dtype, device="cpu"):
    return None if a is None else torch.from_numpy(a).to(device, getattr(torch, dtype))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_inputs(arrays, dtype):
    import jax.numpy as jnp

    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_plain_lse_matches_pallas_interpret(name, dtype):
    import jax.numpy as jnp

    from vitron_tpu.kernels.flash_attention import _flash_forward

    s, t, n, kh, d, off, causal, valid, shift = CASES[name]
    q, k, v, _, mask = _inputs(s, t, n, kh, d, valid)
    jq, jk, jv = _jax_inputs((q, k, v), dtype)
    want_out, want_lse = _flash_forward(
        jq, jk, jv, None if mask is None else jnp.asarray(mask), off, 1.0 / d ** 0.5, 8, 8,
        interpret=True, causal=causal, save_lse=True, softmax_shift=shift)
    got_out, got_lse = fa.flash_attention_plain(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        kv_mask=None if mask is None else torch.from_numpy(mask), q_offset=off,
        causal=causal, softmax_shift=shift, return_lse=True)
    want_lse = np.asarray(want_lse)[:, :, :s]
    live = want_lse > -1e30  # rows that see a key; the others hold NEG_INF + log(1e-30)
    np.testing.assert_array_equal(got_lse.numpy() > -1e30, live)
    assert _rel(got_lse.numpy()[live], want_lse[live]) <= TOL[dtype]
    assert _rel(got_out.float().numpy(), np.asarray(want_out.astype(jnp.float32))) <= TOL[dtype]
    if name == "no_visible_key":
        assert not live[:, :, :4].any() and live[:, :, 4:].all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_jax_grad(name, dtype):
    """The plain backward, and the autograd.Function on the CPU, against
    jax.grad of the Pallas flash attention (interpret mode)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.kernels.flash_attention import flash_attention as jax_flash

    s, t, n, kh, d, off, causal, valid, shift = CASES[name]
    q, k, v, g, mask = _inputs(s, t, n, kh, d, valid, seed=1)
    jq, jk, jv, jg = _jax_inputs((q, k, v, g), dtype)
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, kv_mask=jmask, q_offset=off, block_q=8, block_k=8,
                        interpret=True, causal=causal, softmax_shift=shift)
        return jnp.sum(out.astype(jnp.float32) * jg.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    want = [np.asarray(w.astype(jnp.float32)) for w in want]

    tq, tk, tv, tg = (_torch(a, dtype) for a in (q, k, v, g))
    tmask = None if mask is None else torch.from_numpy(mask)
    scale = 1.0 / d ** 0.5
    out, lse = fa.flash_attention_plain(tq, tk, tv, tmask, off, scale, causal, shift,
                                        return_lse=True)
    plain = fa.flash_attention_bwd_plain(tq, tk, tv, tmask, off, scale, causal, out, lse, tg)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    got_out = fa.flash_attention(*leaves, kv_mask=tmask, q_offset=off, causal=causal,
                                 softmax_shift=shift)
    assert got_out.grad_fn is not None
    auto = torch.autograd.grad(got_out, leaves, tg)
    for what, got in (("plain", plain), ("autograd", auto)):
        for name_, a, w in zip("qkv", got, want):
            rel = _rel(a.float().numpy(), w)
            assert rel <= TOL[dtype], (what, "d" + name_, rel)
    if name == "no_visible_key":  # query slots 0..3 see only masked keys
        assert bool((plain[0][:, :4] == 0).all())


def test_grad_needs_no_flag():
    """Without grad mode or inputs that need a gradient, the forward takes
    no LSE and builds no graph."""
    q = torch.randn(1, 4, 2, 16)
    out = fa.flash_attention(q, q, q)
    assert out.grad_fn is None
    with torch.no_grad():
        assert fa.flash_attention(q.requires_grad_(True), q, q).grad_fn is None


# --------------------------------------------------------------- on the card

CARD_CASES = {  # name: (S, T, N, KH, q_offset, causal, valid, shift)
    "causal_right_padded": (200, 200, 4, 4, 0, True, 170, None),
    "gqa_q_offset": (130, 260, 8, 2, 97, True, 250, None),
    "non_causal": (150, 140, 4, 1, 0, False, 120, None),
    "softmax_shift": (96, 96, 2, 2, 0, True, None, 3.0),
    "no_visible_key": (70, 130, 2, 2, 0, True, -40, None),
    # the tensor-core kernels' edges: S and T one past a multiple of the
    # 64-row and 64/128-key tiles; a GQA group of 4 heads over 4 query tiles
    # with q_offset off the tile grid
    "one_past_tiles": (129, 257, 4, 4, 128, True, None, None),
    "one_past_tiles_non_causal": (129, 257, 4, 2, 0, False, 200, None),
    "gqa4_q_offset": (200, 300, 8, 2, 100, True, 280, None),
}


def _card_inputs(cuda, name, d, dtype):
    s, t, n, kh, off, causal, valid, shift = CARD_CASES[name]
    q, k, v, g, _ = _inputs(s, t, n, kh, d, None, seed=2)
    mask = None
    if valid is not None:
        mask = torch.zeros((2, t), dtype=torch.bool)
        if valid > 0:
            mask[:, :valid] = True  # right padding
        else:
            mask[:, -valid:] = True  # the first -valid slots are invalid
    q, k, v, g = (_torch(a, dtype, cuda) for a in (q, k, v, g))
    return q, k, v, g, None if mask is None else mask.to(cuda), off, causal, shift


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(d, t) for d in fa.BWD_F32_HEAD_DIMS for t in DTYPES]
                         + [(d, "bfloat16") for d in fa.BWD_HEAD_DIMS
                            if d not in fa.BWD_F32_HEAD_DIMS])
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernels_match_plain(cuda, name, d, dtype):
    """B2 with its LSE, B5a and B5b against their plain versions: within
    TOL of the largest output (1e-4 in float32 on the card), each output row
    (query rows of dq, key rows of dk and dv) within the smoke's per-row
    limit (`chip_smoke.flash_row_rel` with its floor), and the same bits twice."""
    import chip_smoke

    q, k, v, g, mask, off, causal, shift = _card_inputs(cuda, name, d, dtype)
    scale = 1.0 / d ** 0.5
    out, lse = fa._forward(q, k, v, mask, off, scale, causal, shift, True)
    want_out, want_lse = fa.flash_attention_plain(q, k, v, mask, off, scale, causal, shift,
                                                  return_lse=True)
    live = want_lse > -1e30
    assert torch.equal(lse > -1e30, live)
    tol = TOL[dtype] * 10 if dtype == "float32" else TOL[dtype]  # float32: 1e-4 on the card
    assert _rel(lse[live].cpu(), want_lse[live].cpu()) <= tol
    assert _rel(out.float().cpu(), want_out.float().cpu()) <= tol
    before = (fa.bwd_kv_launches, fa.bwd_q_launches)
    got = fa.flash_attention_bwd(q, k, v, mask, off, scale, causal, out, lse, g)
    again = fa.flash_attention_bwd(q, k, v, mask, off, scale, causal, out, lse, g)
    torch.cuda.synchronize()
    assert (fa.bwd_kv_launches, fa.bwd_q_launches) == (before[0] + 2, before[1] + 2)
    want = fa.flash_attention_bwd_plain(q, k, v, mask, off, scale, causal, out, lse, g)
    for what, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, b), f"{what}: two runs differ"
        assert _rel(a.float().cpu(), w.float().cpu()) <= tol, what
        row_rel = chip_smoke.flash_row_rel(a, w, chip_smoke.FLASH_BWD_ROW_FLOOR)
        assert row_rel <= chip_smoke.FLASH_BWD_ROW_REL[dtype], (what, row_rel)


@pytest.mark.cuda
def test_autograd_launches_the_kernels(cuda):
    q, k, v, g, mask, off, causal, shift = _card_inputs(cuda, "gqa_q_offset", 128, "bfloat16")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = (fa.launches, fa.bwd_kv_launches, fa.bwd_q_launches)
    out = fa.flash_attention(*leaves, kv_mask=mask, q_offset=off)
    out.backward(g.transpose(1, 2).contiguous().transpose(1, 2))  # a non-contiguous dout
    torch.cuda.synchronize()
    assert (fa.launches, fa.bwd_kv_launches, fa.bwd_q_launches) == tuple(b + 1 for b in before)
    assert all(x.grad is not None and bool(torch.isfinite(x.grad).all()) for x in leaves)


@pytest.mark.cuda
def test_backward_rejects_other_head_dims(cuda):
    """A head dim the backward kernels lack (96), and float32 at the
    bf16-only dims, raise before the forward runs: no plain fallback."""
    q = torch.zeros((1, 8, 2, 96), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="head dim 96"):
        fa.flash_attention(q, q, q)
    for d in (40, 80, 160):
        q = torch.zeros((1, 8, 2, d), device=cuda, requires_grad=True)
        with pytest.raises(NotImplementedError, match=f"float32 at head dim {d}"):
            fa.flash_attention(q, q, q)
