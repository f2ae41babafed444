"""The SEEM slice's kernel: depthwise convolution (B4).

On the CPU the plain version is held against the JAX kernel run as the JAX
package's own tests run it, `_dw_pallas(..., interpret=True)`, and against
its `reference` shift-and-add: float32 to 1e-5 of the output scale (only
the order of at most 81 products differs), bf16 to 2e-2 (output rounding).
The grid planner (`plan`) is held on the CPU: every (pixel, channel) in
one block, at least one block per SM of the H100's 132 at every
FocalNet-L stage and at every ConvNeXt-T (7x7, GLIGEN's hint nets) and
DaViT-T (3x3) site (`chip_smoke.NEW_DW_SITES`), and a block's threads and
shared memory within what the kernel and the card take. The `cuda`-marked
tests hold the hand kernel against its plain version on the card at
FocalNet-L's, ConvNeXt-T's and DaViT-T's shapes and ragged ones: within the global tolerance, within `chip_smoke.PIXEL_REL` of each
output pixel's largest |plain|, the same bits twice; and check that
unsupported kernels and dtypes raise. JAX is imported inside the CPU tests
only.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from vitron_tpu_torch.kernels import depthwise_conv as dw
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


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


# ---------------------------------------------------------------- the planner

FOCALNET_STAGES = [(1, 128, 128, 192), (1, 64, 64, 384), (1, 32, 32, 768), (1, 16, 16, 1536)]
RAGGED = [(2, 37, 53, 200), (1, 5, 3, 48), (3, 1, 70, 33), (2, 9, 130, 20)]


NEW_STAGES = [shape for shape, _ in chip_smoke.NEW_DW_SITES]


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", FOCALNET_STAGES + RAGGED + NEW_STAGES)
def test_grid_covers_every_pixel_and_channel_once(shape, itemsize):
    """The blocks of `plan` tile [B, H, W, C] exactly once, as the kernel
    reads its block indices, at every kernel size; their threads and shared
    memory fit a block."""
    b, h, w, c = shape
    for k in dw.KERNEL_SIZES:
        p = dw.plan(*shape, k, itemsize)
        count = np.zeros(shape, np.int8)
        segs = p.grid[2] // b
        for gx in range(p.grid[0]):
            for gy in range(p.grid[1]):
                for gz in range(p.grid[2]):
                    bi, h0 = gz // segs, (gz % segs) * p.hs
                    rows = min(p.hs, h - h0)
                    assert rows > 0
                    count[bi, h0:h0 + rows, gy * p.tw:(gy + 1) * p.tw,
                          gx * p.channels:(gx + 1) * p.channels] += 1
        assert (count == 1).all(), k
        assert p.threads <= dw.MAX_THREADS and p.tw % dw.COLS == 0
        assert p.lanes & (p.lanes - 1) == 0
        assert p.vec in (1, 16 // itemsize) and (p.vec == 1 or c % p.vec == 0)
        assert p.smem_bytes(k) <= 227 * 1024


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("shape", FOCALNET_STAGES)
def test_grid_fills_the_card_at_every_focalnet_stage(shape, itemsize):
    for k in dw.KERNEL_SIZES:
        p = dw.plan(*shape, k, itemsize)
        assert p.blocks >= dw.SM_COUNT and p.vec == 16 // itemsize, k


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("site", chip_smoke.NEW_DW_SITES, ids=str)
def test_grid_fills_the_card_at_convnext_and_davit_sites(site, itemsize):
    """ConvNeXt-T's 7x7 stages at a 448 hint and DaViT-T's 3x3 stages at
    512x512: at least one block for each SM, in both types (the 16-lane
    plan of the narrow bf16 maps gives too few and yields to 8 lanes)."""
    shape, k = site
    p = dw.plan(*shape, k, itemsize)
    assert p.blocks >= dw.SM_COUNT and p.vec == 16 // itemsize, p


# ---------------------------------------------------------------- on the card

# FocalNet-L at a 512x512 input (stage x, k = 3/5/7/9), ragged cases, and
# ConvNeXt-T's and DaViT-T's sites
DW_SITES = ([((1, 128, 128, 192), k) for k in (3, 5, 7, 9)]
            + [((1, 64, 64, 384), k) for k in (3, 5, 7, 9)]
            + [((1, 32, 32, 768), k) for k in (3, 5, 7, 9)]
            + [((1, 16, 16, 1536), k) for k in (3, 5, 7, 9)]
            + [((2, 37, 53, 200), 5), ((1, 5, 3, 48), 9), ((3, 1, 70, 33), 7),
               ((2, 9, 130, 20), 3)]
            + list(chip_smoke.NEW_DW_SITES))


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
    name = str(dtype).split(".")[-1]
    assert chip_smoke.flash_row_rel(got, want) <= chip_smoke.PIXEL_REL[name]
    assert torch.equal(got, dw.depthwise_conv2d(x, w))


@pytest.mark.cuda
def test_unsupported_kernels_and_dtypes_raise(cuda):
    x = torch.zeros((1, 8, 8, 16), device=cuda)
    with pytest.raises(NotImplementedError, match="k=11"):
        dw.depthwise_conv2d(x, torch.zeros((11, 11, 16), device=cuda))
    with pytest.raises(TypeError, match="float32/bfloat16"):
        dw.depthwise_conv2d(x.half(), torch.zeros((3, 3, 16), device=cuda).half())
    with pytest.raises(TypeError, match="is not x's"):
        dw.depthwise_conv2d(x, torch.zeros((3, 3, 16), device=cuda).to(torch.bfloat16))
