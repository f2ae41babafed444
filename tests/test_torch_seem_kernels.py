"""The SEEM slice's kernel: depthwise convolution (B4).

On the CPU the plain version is held against the JAX kernel run as the JAX
package's own tests run it, `_dw_pallas(..., interpret=True)`, and against
its `reference` shift-and-add: float32 to 1e-5 of the output scale (only
the order of at most 81 products differs), bf16 to 2e-2 (output rounding).
The `cuda`-marked tests hold the hand kernel against its plain version on
the card at FocalNet-L's shapes and a ragged one, and check that
unsupported kernels and dtypes raise. JAX is imported inside the CPU tests
only.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import depthwise_conv as dw


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


def _inputs(shape, k, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            (rs.randn(k, k, shape[-1]) / k).astype(np.float32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", [((1, 9, 11, 48), 3), ((2, 13, 7, 48), 5),
                                     ((1, 10, 12, 200), 7), ((1, 17, 15, 200), 9)])
def test_plain_matches_pallas_interpret_and_reference(shape, k, dtype):
    import jax.numpy as jnp

    from vitron_tpu.kernels.depthwise_conv import _dw_pallas, reference

    x, w = _inputs(shape, k, seed=k)
    jdt = getattr(jnp, dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    got = dw.depthwise_conv2d(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    tol = 1e-5 if dtype == "float32" else 2e-2
    for want in (_dw_pallas(jx, jw, interpret=True), reference(jx, jw)):
        assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol


def test_hwio_weights_and_bias_match_jax():
    import jax.numpy as jnp

    from vitron_tpu.kernels.depthwise_conv import depthwise_conv2d as jax_dw

    x, w = _inputs((1, 8, 9, 48), 5, seed=1)
    b = np.random.RandomState(2).randn(48).astype(np.float32)
    want = jax_dw(jnp.asarray(x), jnp.asarray(w[:, :, None, :]), jnp.asarray(b))
    got = dw.depthwise_conv2d(torch.from_numpy(x), torch.from_numpy(w[:, :, None, :]),
                              torch.from_numpy(b))
    assert _rel(got.numpy(), want) <= 1e-5


def test_bad_kernels_raise():
    x = torch.zeros((1, 4, 4, 8))
    for shape in ((4, 4, 8), (3, 5, 8), (3, 3, 2, 8)):
        with pytest.raises(ValueError, match="odd square kernel|one input channel"):
            dw.depthwise_conv2d(x, torch.zeros(shape))
    with pytest.raises(ValueError, match="do not match"):
        dw.depthwise_conv2d(x, torch.zeros((3, 3, 6)))


def test_never_falls_back_off_cpu():
    """Only CPU tensors take the plain version: any other device launches
    the kernel or raises (meta tensors stand in for a non-CPU device)."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        dw.depthwise_conv2d(torch.zeros((1, 4, 4, 8), device=meta),
                            torch.zeros((3, 3, 8), device=meta))


# ---------------------------------------------------------------- on the card

# FocalNet-L at a 512x512 input (stage x, k = 3/5/7/9) and ragged cases
DW_SITES = ([((1, 128, 128, 192), k) for k in (3, 5, 7, 9)]
            + [((1, 64, 64, 384), k) for k in (3, 5, 7, 9)]
            + [((1, 32, 32, 768), k) for k in (3, 5, 7, 9)]
            + [((1, 16, 16, 1536), k) for k in (3, 5, 7, 9)]
            + [((2, 37, 53, 200), 5), ((1, 5, 3, 48), 9), ((3, 1, 70, 33), 7)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,k", DW_SITES)
def test_kernel_matches_plain(cuda, shape, k, dtype):
    g = torch.Generator(device=cuda).manual_seed(k + shape[-1])
    x = torch.randn(shape, generator=g, device=cuda).to(dtype)
    w = (torch.randn((k, k, shape[-1]), generator=g, device=cuda) / k).to(dtype)
    before = dw.launches
    got = dw.depthwise_conv2d(x, w)
    torch.cuda.synchronize()
    assert dw.launches == before + 1
    want = dw.depthwise_conv2d_plain(x, w)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.cuda
def test_unsupported_kernels_and_dtypes_raise(cuda):
    x = torch.zeros((1, 8, 8, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="k=11"):
        dw.depthwise_conv2d(x, torch.zeros((11, 11, 16), device=cuda))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        dw.depthwise_conv2d(x.half(), torch.zeros((3, 3, 16), device=cuda).half())
    with pytest.raises(TypeError, match="is not x's"):
        dw.depthwise_conv2d(x, torch.zeros((3, 3, 16), device=cuda).to(torch.bfloat16))
