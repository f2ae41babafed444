"""Parity of the port's flash-attention forward with the JAX Pallas kernel
(run in interpret mode, as the JAX package's own tests run it on the CPU),
and of the hand CUDA kernel with its plain version (on a card).

Every case gives both packages the same numpy inputs from a seeded
RandomState; float32 tolerance rtol=atol=1e-4. The "no-visible-key" cases
hit, on purpose, query rows that see no valid key: the kernel (TPU and
CUDA) and the plain version give zeros there. JAX is imported inside the
parity tests, so the `cuda` tests also run where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import flash_attention as fa

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
    # float32: order of sums only; bfloat16: the output rounding (inputs unit normal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    if name == "no_visible_key":
        assert bool((got[:, :20] == 0).all())


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
