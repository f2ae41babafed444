"""The diffusion slice's kernels: GEGLU feed-forward (B3), group-norm sums
(B8) and flash attention at the diffusion head dims (B2: 40, 80, 160, 512).

On the CPU the plain versions are held against the JAX kernels run as the
JAX package's own tests run them: `_geglu_ff_fwd(..., interpret=True)` (its
tanh gelu: bf16 tolerance) and `_xla_geglu` (erf gelu, as here: float32
tolerance), `_sums_pallas(..., interpret=True)` and `flash_attention` in
interpret mode (non-causal, shift 0, as `layers._mha` calls it). The
`cuda`-marked tests hold each hand kernel against its plain version on the
card at the GLIGEN shapes, check that group-norm sums are the same bits run
to run, and that unsupported shapes and dtypes raise. JAX is imported inside
the CPU tests only.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import flash_attention as fa
from vitron_tpu_torch.kernels import geglu_ff as gf
from vitron_tpu_torch.kernels import group_norm as gn


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


def _geglu_inputs(m, c, f, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, c).astype(np.float32),
            (rs.randn(c, 2 * f) / np.sqrt(c)).astype(np.float32),
            (0.1 * rs.randn(2 * f)).astype(np.float32),
            (rs.randn(f, c) / np.sqrt(f)).astype(np.float32),
            (0.1 * rs.randn(c)).astype(np.float32))


def test_geglu_plain_matches_xla_form():
    """Float32: the plain version is `_xla_geglu`'s arithmetic (erf gelu)."""
    import jax.numpy as jnp

    from vitron_tpu.kernels.geglu_ff import _xla_geglu

    args = _geglu_inputs(96, 64, 256)
    want = _xla_geglu(*(jnp.asarray(a) for a in args))
    got = gf.geglu_ff(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_geglu_plain_matches_pallas_interpret():
    """bf16 in and out: the Pallas kernel's tanh gelu differs from erf by at
    most ~1e-3 before the hidden tile is rounded to bf16, so the tolerance is
    the bf16 one (3e-2 on outputs of scale ~1)."""
    import jax.numpy as jnp

    from vitron_tpu.kernels.geglu_ff import _geglu_ff_fwd

    args = _geglu_inputs(128, 64, 256, seed=1)
    want = _geglu_ff_fwd(*(jnp.asarray(a, jnp.bfloat16) for a in args), interpret=True)
    got = gf.geglu_ff(*(torch.from_numpy(a).to(torch.bfloat16) for a in args))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("shape", [(2, 100, 32), (1, 1300, 130), (3, 7, 5)])
def test_group_norm_plain_matches_pallas_interpret(shape):
    import jax.numpy as jnp

    from vitron_tpu.kernels.group_norm import _sums_pallas, _sums_xla

    x = (np.random.RandomState(2).randn(*shape) * 2 + 0.5).astype(np.float32)
    got = gn.group_norm_sums(torch.from_numpy(x)).numpy()
    for want in (_sums_pallas(jnp.asarray(x), interpret=True), _sums_xla(jnp.asarray(x))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("d,s,t", [(40, 20, 36), (80, 24, 24), (512, 12, 20)])
def test_flash_plain_matches_pallas_interpret(d, s, t):
    """Non-causal, softmax_shift 0, no mask: the diffusion sites' call."""
    import jax.numpy as jnp

    from vitron_tpu.kernels.flash_attention import flash_attention as jax_flash

    rs = np.random.RandomState(d)
    heads = 1 if d == 512 else 2
    q = rs.randn(2, s, heads, d).astype(np.float32) * 0.3
    k = rs.randn(2, t, heads, d).astype(np.float32) * 0.3
    v = rs.randn(2, t, heads, d).astype(np.float32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                     softmax_shift=0.0, scale=d ** -0.5, block_q=4, block_k=4, interpret=True)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             causal=False, softmax_shift=0.0, scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_never_falls_back_off_cpu():
    """Only CPU tensors take the plain versions: any other device launches
    the kernel or raises (meta tensors stand in for a non-CPU device)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        gn.group_norm_sums(torch.zeros((1, 4, 8), device=meta))
    x = torch.zeros((4, 320), device=meta)
    with pytest.raises(ValueError, match="CUDA device"):
        gf.geglu_ff(x, torch.zeros((320, 2560), device=meta), torch.zeros(2560, device=meta),
                    torch.zeros((1280, 320), device=meta), torch.zeros(320, device=meta))


# ---------------------------------------------------------------- on the card

# (M, C, F) of the SD UNet's feed-forward sites (CFG batch 2) and ragged M
GEGLU_SITES = [(8192, 320, 1280), (2048, 640, 2560), (512, 1280, 5120), (128, 1280, 5120),
               (1000, 320, 1280), (77, 640, 2560)]


def _on(device, arrays, dtype):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c,f", GEGLU_SITES)
def test_geglu_kernel_matches_plain(cuda, m, c, f, dtype):
    args = _on(cuda, _geglu_inputs(m, c, f, seed=m), dtype)
    before = gf.launches
    got = gf.geglu_ff(*args)
    torch.cuda.synchronize()
    assert gf.launches == before + 1
    want = gf.geglu_ff_plain(*args)
    # float32: order of sums only; bf16: the rounding of the hidden tile and
    # the output (values of scale ~1)
    tol = 1e-4 if dtype == torch.float32 else 3e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 4096, 320), (2, 1024, 640), (1, 262144, 128),
                                   (2, 64, 1280), (3, 37, 40)])
def test_group_norm_kernel_matches_plain_and_is_deterministic(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = (torch.randn(shape, generator=g, device=cuda) * 2 + 0.5).to(dtype)
    before = gn.launches
    got = gn.group_norm_sums(x)
    again = gn.group_norm_sums(x)
    torch.cuda.synchronize()
    assert gn.launches == before + 2
    assert torch.equal(got, again)  # fixed-order sums: identical bits
    want = gn.group_norm_sums_plain(x)
    # float32 sums of up to 262144 rows in two orders
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3 * shape[1] ** 0.5)


# (B, S, T, heads, D): the GLIGEN sites (self-attention and fuser at 64x64
# and 32x32 latents, the VAE mid attention), D = 160 and small ragged cases
FLASH_SITES = [(2, 4096, 4096, 8, 40), (2, 4126, 4126, 8, 40), (2, 1024, 1024, 8, 80),
               (2, 1054, 1054, 8, 80), (1, 4096, 4096, 1, 512), (2, 300, 300, 8, 160),
               (1, 77, 133, 2, 512), (2, 70, 97, 3, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,t,h,d", FLASH_SITES)
def test_flash_diffusion_dims_match_plain(cuda, b, s, t, h, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(d + s)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, s, h, d), (b, t, h, d), (b, t, h, d)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=False, softmax_shift=0.0)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, causal=False, softmax_shift=0.0)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_unsupported_shapes_and_dtypes_raise(cuda):
    x = torch.zeros((4, 258), device=cuda)  # C not a multiple of 8
    with pytest.raises(NotImplementedError, match="C=258"):
        gf.geglu_ff(x, torch.zeros((258, 2064), device=cuda), torch.zeros(2064, device=cuda),
                    torch.zeros((1032, 258), device=cuda), torch.zeros(258, device=cuda))
    x = torch.zeros((4, 320), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32"):
        gf.geglu_ff(x, *(torch.zeros(s, device=cuda, dtype=torch.float16)
                         for s in ((320, 2560), (2560,), (1280, 320), (320,))))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        gn.group_norm_sums(torch.zeros((1, 4, 8), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        gn.group_norm_sums(torch.zeros((1, 8, 4), device=cuda).transpose(1, 2))
    q = torch.zeros((1, 4, 2, 96), device=cuda)
    with pytest.raises(NotImplementedError, match="head dim 96"):
        fa.flash_attention(q, q, q, causal=False)
