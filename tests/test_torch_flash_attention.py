"""Parity of the port's flash-attention forward with the JAX Pallas kernel
(run in interpret mode, as the JAX package's own tests run it on the CPU),
and of the hand CUDA kernel with its plain version (on a card).

Every case gives both packages the same numpy inputs from a seeded
RandomState; float32 tolerance rtol=atol=1e-4. In bfloat16 the plain version
rounds q * scale and p where the TPU kernel does, and is held to it in
bf16 ulps (`test_plain_bf16_rounds_as_pallas_interpret`). The
"no-visible-key" cases hit, on purpose, query rows that see no valid key:
the kernel (TPU and CUDA) and the plain version give zeros there. JAX is
imported inside the parity tests, so the `cuda` tests also run where JAX is
not installed.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import flash_attention as fa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = ATOL = 1e-4

# name: (S, T, N, KH, D, q_offset, causal, valid slots (None = no mask), shift)
CASES = {
    "causal": (16, 16, 4, 4, 32, 0, True, None, None),
    "q_offset": (8, 24, 4, 4, 32, 12, True, None, None),
    "kv_mask": (16, 16, 4, 4, 32, 0, True, [0, 1, 2, 5, 6, 9, 10, 11, 12, 15], None),
    "gqa": (16, 24, 4, 2, 32, 8, True, None, None),
    "t_padding": (12, 20, 2, 2, 16, 8, True, None, None),
    "non_causal": (12, 20, 2, 1, 16, 0, False, list(range(3, 17)), None),
    "no_visible_key": (8, 16, 2, 2, 16, 0, True, list(range(4, 16)), None),
    "softmax_shift": (16, 16, 2, 2, 16, 0, True, None, 4.0),
}


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
    mask = None
    if valid is not None:
        mask = np.zeros((2, t), bool)
        mask[:, valid] = True
        mask[1, valid[-1]] = False  # the rows differ
    return q, k, v, mask


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(name):
    import jax.numpy as jnp

    from vitron_tpu.kernels.flash_attention import flash_attention as jax_flash

    s, t, n, kh, d, off, causal, valid, shift = CASES[name]
    q, k, v, mask = _inputs(s, t, n, kh, d, valid)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     kv_mask=None if mask is None else jnp.asarray(mask), q_offset=off,
                     block_q=8, block_k=8, interpret=True, causal=causal,
                     softmax_shift=shift)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             kv_mask=None if mask is None else torch.from_numpy(mask),
                             q_offset=off, causal=causal, softmax_shift=shift)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    if name == "no_visible_key":  # query slots 0..3 see only masked keys
        assert np.all(got.numpy()[:, :4] == 0.0)


# bf16 against the Pallas kernel: (S, T, N, KH, D, q_offset, causal, valid
# slots (None = no mask), shift). Shift 0 is the diffusion sites' call; the
# running-max cases are the LLM's (causal, q_offset, kv_mask, GQA).
BF16_CASES = {
    "d40_shift0": (24, 40, 2, 2, 40, 0, False, None, 0.0),
    "d80_shift0_gqa": (20, 36, 2, 1, 80, 0, False, None, 0.0),
    "d512_shift0": (20, 36, 1, 1, 512, 0, False, None, 0.0),
    "d64_running_max": (24, 40, 4, 2, 64, 16, True,
                        [0, 1, 2, 5, 6, 9, 10, 11, 12, 15, 20, 25, 30, 31, 33, 39], None),
    "d128_running_max": (20, 40, 4, 1, 128, 20, True, list(range(3, 38)), None),
}


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126))) - 7)


@pytest.mark.parametrize("save_lse", [False, True])
@pytest.mark.parametrize("name", list(BF16_CASES))
def test_plain_bf16_rounds_as_pallas_interpret(name, save_lse):
    """bfloat16: the plain version rounds q * scale to bf16 before the
    logits and p to bf16 before p @ v, summing the unrounded p, as the TPU
    kernel does. Where the kernel rounds p against the row max (softmax
    shift, or one key block, whose running max is the row max) the two
    agree to the bit, except that float32 sums taken in another order
    (XLA's dot against torch's einsum) may cross a bf16 rounding boundary:
    such an element differs by one ulp, at most one in 1,000 (1 in 3,840
    measured). With 16-key blocks the running max rounds p against other
    bases, and the outputs agree within one ulp of their largest magnitude.
    A plain version without those roundings differs in 31-48% of the
    elements, by up to 2^-7."""
    import jax.numpy as jnp

    from vitron_tpu.kernels.flash_attention import _flash_forward

    s, t, n, kh, d, off, causal, valid, shift = BF16_CASES[name]
    q, k, v, mask = _inputs(s, t, n, kh, d, valid)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    jmask = None if mask is None else jnp.asarray(mask)

    def jax_flash(block_k):
        res = _flash_forward(jq, jk, jv, jmask, off, d ** -0.5, 16, block_k, interpret=True,
                             causal=causal, save_lse=save_lse, softmax_shift=shift)
        out, lse = res if save_lse else (res, None)
        return np.asarray(out.astype(jnp.float32)), lse

    got = fa.flash_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        kv_mask=None if mask is None else torch.from_numpy(mask), q_offset=off, causal=causal,
        softmax_shift=shift, return_lse=save_lse)
    got, got_lse = got if save_lse else (got, None)
    got = got.float().numpy()

    want, _ = jax_flash(16 if shift is not None else t)
    diff = np.abs(got - want)
    assert np.all(diff <= _bf16_ulp(want)), float((diff / _bf16_ulp(want)).max())
    assert np.count_nonzero(diff) <= diff.size // 1000, np.count_nonzero(diff)
    want16, want_lse = jax_flash(16)
    if shift is None:
        assert np.abs(got - want16).max() <= _bf16_ulp(np.abs(want16).max())
    if save_lse:
        want_lse = np.asarray(want_lse)[:, :, :s]
        np.testing.assert_allclose(got_lse.numpy(), want_lse, rtol=1e-6, atol=1e-6)


def test_reference_attention_matches_jax():
    import jax.numpy as jnp

    from vitron_tpu.kernels.flash_attention import reference_attention

    q, k, v, mask = _inputs(8, 16, 4, 2, 16, list(range(2, 16)), seed=1)
    want = reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_mask=jnp.asarray(mask))
    got = fa.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), kv_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda, name, d, dtype):
    s, t, n, kh, _, off, causal, valid, shift = CASES[name]
    # stretch the sequence dims past one 64-row tile, keep the raggedness
    s, t, off = s * 5 + 3, t * 5 + 3, off * 5
    valid = None if valid is None else [j * 5 + r for j in valid for r in range(5)]
    q, k, v, mask = (None if a is None else torch.from_numpy(a).to(cuda)
                     for a in _inputs(s, t, n, kh, d, valid))
    q, k, v = (a.to(dtype) for a in (q, k, v))
    before = fa.launches
    got = fa.flash_attention(q, k, v, kv_mask=mask, q_offset=off, causal=causal,
                             softmax_shift=shift)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, kv_mask=mask, q_offset=off, causal=causal,
                                    softmax_shift=shift)
    # float32: order of sums only; bfloat16: the output rounding (inputs unit normal),
    # also at each query row's own scale
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    if dtype == torch.bfloat16:
        _assert_rows_close(got, want)
    if name == "no_visible_key":
        assert bool((got[:, :20] == 0).all())


# The bf16 tensor-core path at every head dim: (B, S, T, N, KH, q_offset,
# causal, valid slots, shift, lse). valid: None = no mask, ("pad", j) = the
# first j slots, ("from", j) = slots j.. (the rows of query slots < j see no
# key), ("holes", j) = every slot but multiples of 7, below j.
BF16_CARD_CASES = {
    "shift0_ragged": (2, 4126, 1054, 2, 2, 0, False, None, 0.0, False),
    "shift0_short_q": (2, 15, 2880, 2, 1, 0, False, None, 0.0, True),
    "non_causal_running_max": (1, 300, 2880, 4, 2, 0, False, ("pad", 2700), None, True),
    "causal_gqa_holes": (2, 300, 700, 32, 8, 400, True, ("holes", 650), None, True),
    "one_row": (2, 1, 1054, 4, 2, 1053, True, ("holes", 1000), None, True),
    "no_visible_key": (2, 70, 130, 4, 4, 0, True, ("from", 40), None, True),
    "shift_causal_padded": (2, 200, 200, 4, 4, 0, True, ("pad", 170), 3.0, True),
}


def _card_mask(b, t, valid):
    if valid is None:
        return None
    kind, j = valid
    mask = torch.zeros((b, t), dtype=torch.bool)
    if kind == "pad":
        mask[:, :j] = True
    elif kind == "from":
        mask[:, j:] = True
    else:
        mask[:, :j] = True
        mask[:, :j:7] = False
    mask[-1, j if kind == "from" else j - 1] = False  # the rows differ
    return mask


def _assert_rows_close(got, want):
    """bf16 B2 against its plain version at each query row's scale: max
    |got - want| over the row's D outputs at most FLASH_ROW_REL (2^-6) of
    the row's largest |want|, the smoke's limit (a row of plain zeros must
    be zeros)."""
    import chip_smoke

    row_rel = chip_smoke.flash_row_rel(got, want)
    assert row_rel <= chip_smoke.FLASH_ROW_REL, f"row rel err {row_rel}"


@pytest.mark.cuda
@pytest.mark.parametrize("d", fa.KERNEL_HEAD_DIMS)
@pytest.mark.parametrize("name", list(BF16_CARD_CASES))
def test_bf16_kernel_matches_plain(cuda, name, d):
    """The tensor-core kernel against the plain version: out within 2e-2
    and, at each query row, within 2^-6 of the row's largest output (the
    plain version rounds p against the row max, the kernel against its
    running max; unit-normal inputs), the LSE within 1e-3 (float32 sums in
    another order, ex2.approx), zeros and the same LSE where a row sees no
    key, and the same bits on a second call."""
    b, s, t, n, kh, off, causal, valid, shift, want_lse = BF16_CARD_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(d + s)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(torch.bfloat16)
               for shape in ((b, s, n, d), (b, t, kh, d), (b, t, kh, d)))
    mask = _card_mask(b, t, valid)
    mask = None if mask is None else mask.to(cuda)
    scale = d ** -0.5
    before = fa.launches
    out, lse = fa._forward(q, k, v, mask, off, scale, causal, shift, want_lse)
    again, lse2 = fa._forward(q, k, v, mask, off, scale, causal, shift, want_lse)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert torch.equal(out, again)
    want = fa.flash_attention_plain(q, k, v, mask, off, scale, causal, shift,
                                    return_lse=want_lse)
    want, want_l = want if want_lse else (want, None)
    assert (out.float() - want.float()).abs().max().item() <= 2e-2
    _assert_rows_close(out, want)
    if want_lse:
        assert torch.equal(lse, lse2)
        live = want_l > -1e30
        assert torch.equal(lse > -1e30, live)
        assert torch.equal(lse[~live], want_l[~live])
        assert (lse[live] - want_l[live]).abs().max().item() <= 1e-3
    if name == "no_visible_key":  # query slots 0..39 see only masked keys
        assert bool((out[:, :40] == 0).all()) and not bool(live[:, :, :40].any())


@pytest.mark.cuda
def test_kernel_rejects_other_head_dims(cuda):
    q = torch.zeros((1, 4, 2, 48), device=cuda)
    with pytest.raises(NotImplementedError, match="head dim 48"):
        fa.flash_attention(q, q, q)


def test_never_falls_back_off_cpu():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises (meta tensors stand in for a non-CPU device)."""
    q = torch.zeros((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, q, q)


@pytest.mark.parametrize("t,drop", [(4126, slice(4096, None)), (4096, slice(2048, 2112))])
def test_row_limit_catches_dropped_keys(t, drop):
    """The per-row limit the card checks hold bf16 B2 to sits between one
    bf16 ulp of every output (passes) and a kernel that drops the 30-key
    ragged tail at 4,126 keys or one 64-key tile at 4,096 (fails in every
    query row), on unit-normal inputs as the card checks use."""
    import chip_smoke

    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(8, t, 2, 2, 40, None)[:3])
    keep = torch.ones(t, dtype=torch.bool)
    keep[drop] = False
    want = fa.flash_attention_plain(q, k, v, causal=False, softmax_shift=0.0)
    faulty = fa.flash_attention_plain(q, k[:, keep], v[:, keep], causal=False, softmax_shift=0.0)
    one_ulp = (want.float() * (1 + 2 ** -8)).to(torch.bfloat16)
    assert (one_ulp != want).any()
    assert chip_smoke.flash_row_rel(one_ulp, want) <= 2 ** -7 < chip_smoke.FLASH_ROW_REL
    diff = (faulty.float() - want.float()).abs().amax(-1) / want.float().abs().amax(-1)
    assert diff.min().item() > chip_smoke.FLASH_ROW_REL


@pytest.mark.parametrize("d", [64, 128])
def test_bwd_row_limit_catches_dropped_tiles(d):
    """The per-row limit the card checks hold bf16 B5a and B5b to
    (`chip_smoke.flash_row_rel` with FLASH_BWD_ROW_FLOOR) sits between one bf16 ulp of every
    output (passes) and a dq missing one 64-key tile or a dk/dv missing one
    64-query tile (fails in every row), on unit-normal inputs as the card
    checks use (non-causal, 512 queries and keys)."""
    import chip_smoke

    s = t = 512
    rs = np.random.RandomState(d)
    q, k, v, dout = (torch.from_numpy(rs.randn(2, n, 2, d).astype(np.float32)).to(torch.bfloat16)
                     for n in (s, t, t, s))
    scale = d ** -0.5
    out, lse = fa.flash_attention_plain(q, k, v, None, 0, scale, False, return_lse=True)
    args = (None, 0, scale, False)
    want_dq = fa.flash_attention_bwd_q_plain(q, k, v, *args, out, lse, dout)
    want_dk, want_dv = fa.flash_attention_bwd_kv_plain(q, k, v, *args, out, lse, dout)
    keep = torch.ones(t, dtype=torch.bool)
    keep[192:256] = False  # one 64-slot tile
    faults = {
        "dq": (fa.flash_attention_bwd_q_plain(q, k[:, keep], v[:, keep], *args, out, lse, dout),
               want_dq)}
    dk, dv = fa.flash_attention_bwd_kv_plain(q[:, keep], k, v, *args, out[:, keep],
                                             lse[:, :, keep], dout[:, keep])
    faults.update(dk=(dk, want_dk), dv=(dv, want_dv))
    limit = chip_smoke.FLASH_BWD_ROW_REL["bfloat16"]
    for what, (faulty, want) in faults.items():
        one_ulp = (want.float() * (1 + 2 ** -8)).to(torch.bfloat16)
        assert (one_ulp != want).any()
        floor = chip_smoke.FLASH_BWD_ROW_FLOOR
        assert chip_smoke.flash_row_rel(one_ulp, want, floor) <= 2 ** -7 < limit, what
        diff = (faulty.float() - want.float()).abs().amax(-1) / want.float().abs().amax(-1)
        assert diff.min().item() > limit, (what, diff.min().item())
