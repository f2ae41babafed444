"""The 3x3 stride-1 SAME conv (B9): the port's `conv3x3_same` against the JAX
package's, and on the card the hand kernel against its plain version.

On the CPU the port's function is held against JAX's `conv3x3_same(...,
interpret=True)`, the Pallas kernel run as the JAX package's own tests run
it (`tests/test_conv2d.py`). The eligibility rule decides the function, not
only the speed, in both packages: at an eligible shape (C and D multiples of
128, W of 8, the TPU tiling's VMEM need within its limit) x and w are
rounded to bf16 and the taps summed in float32, and at any other shape the
result is the exact conv in the input dtype (JAX's `lax.conv` fallback, the
port's `F.conv2d`, on the CPU and on the card). Tolerances are max
|port - JAX| / max |JAX|: 1e-5 in float32 (both sides multiply the same
bf16 values exactly and differ only in the order of float32 sums), 1e-2 for
a bf16 output (one rounding of the output on each side). The gradients
(dx through the same conv with the flipped filter, dw from the unrounded
taps) are held against `jax.vjp` of the interpret-mode kernel at 1e-5.

The box planner (`plan_boxes`, the pixel rectangle of one block, whose A
tile is a TMA box) is held on the CPU: at every shape it covers each output
pixel exactly once, and its boxes stay within TMA's limits.

The `cuda`-marked tests hold the hand kernel against the plain version on
the card at every eligible 3x3 conv of the i2vgen UNet at task G's 64x64
latents (batch 2 x 16 frames; `unet_sd_video.conv3x3_sites`, from the
block plan), at ragged shapes and with every box shape the planner can
choose, float32 and bf16: within the global tolerance, within
`chip_smoke.PIXEL_REL` of each output pixel's largest |plain| (which a
dropped 64-channel block of one tap fails), and the same bits twice; its gradients against `conv3x3_vjp_plain`; and that the wrapper
launches the kernel at eligible shapes, runs the exact conv at the others
and raises where it has no kernel.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from vitron_tpu_torch.kernels import conv2d as cv
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F32_TOL, BF16_TOL = 1e-5, 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    got = got.detach().float().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(
        got, np.float32)
    want = want.detach().float().cpu().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _inputs(b, h, w, c, d, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, w, c).astype(np.float32),
            (rs.randn(3, 3, c, d) * 0.05).astype(np.float32),
            (rs.randn(d) * 0.1).astype(np.float32))


def _j(a, dtype="float32"):
    import jax.numpy as jnp

    return jnp.asarray(a, getattr(jnp, dtype))


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


# ---------------------------------------------------------------- the CPU

# test_conv2d.py's two eligible shapes and a ragged H (7 rows: one row
# block of 7 in the TPU tiling, a partial 128-row tile in the kernel's)
ELIGIBLE = [(1, 8, 16, 128, 128), (2, 6, 8, 128, 256), (1, 7, 8, 128, 128)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ELIGIBLE)
def test_plain_matches_the_interpret_mode_kernel(shape, dtype):
    from vitron_tpu.kernels.conv2d import conv3x3_same as jconv

    x, w, b = _inputs(*shape)
    assert cv.eligible(x.shape, shape[-1], getattr(torch, dtype))
    got = cv.conv3x3_same(_t(x, dtype), _t(w, dtype), _t(b, dtype))
    want = jconv(_j(x, dtype), _j(w, dtype), _j(b, dtype), interpret=True)
    assert got.dtype == getattr(torch, dtype) and str(want.dtype) == dtype
    assert _rel(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_eligible_shapes_round_to_bf16_and_the_others_do_not():
    """The eligible function is the bf16-tap conv, not the exact one: at
    C = 128 it is ~1e-3 from the float32 conv, the plain version is that
    rounding, and the ineligible C = 16 conv is exact."""
    x, w, _ = _inputs(1, 8, 16, 128, 128)
    got = cv.conv3x3_same(_t(x), _t(w))
    exact = cv.conv3x3_exact(_t(x), _t(w))
    assert 1e-4 < _rel(got, exact) < 1e-2
    rounded = cv.conv3x3_exact(_t(x).to(torch.bfloat16).float(), _t(w).to(torch.bfloat16).float())
    assert _rel(got, rounded) <= F32_TOL
    xs, ws, _ = _inputs(1, 8, 8, 16, 32)
    assert torch.equal(cv.conv3x3_same(_t(xs), _t(ws)), cv.conv3x3_exact(_t(xs), _t(ws)))


@pytest.mark.parametrize("shape", [(1, 8, 8, 16, 32), (1, 8, 12, 128, 128), (2, 4, 8, 128, 64)])
def test_ineligible_shapes_match_the_jax_fallback(shape):
    """C = 16, W = 12 (not a multiple of 8) and D = 64 go to the exact conv
    in the input dtype, as JAX's `lax.conv_general_dilated` fallback."""
    from vitron_tpu.kernels.conv2d import conv3x3_same as jconv

    x, w, b = _inputs(*shape, seed=3)
    assert not cv.eligible(x.shape, shape[-1], torch.float32)
    got = cv.conv3x3_same(_t(x), _t(w), _t(b))
    want = jconv(_j(x), _j(w), _j(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_the_eligibility_rule():
    """JAX's predicate at the shapes that decide it: the multiples of 128
    and 8, and the VMEM need of the smallest row block (a 1024-wide row of
    4096 channels does not fit in 100 MiB). The 16 task-G sites are
    eligible; the i2vgen UNet's conv_in (8 -> 512) and out (512 -> 4) not."""
    f32 = torch.float32
    assert cv.eligible((2, 64, 64, 512), 512, f32)
    assert cv.eligible((1, 1, 8, 128), 128, torch.bfloat16)
    assert not cv.eligible((1, 16, 1024, 4096), 512, f32)
    assert cv.eligible((1, 16, 64, 4096), 512, f32)
    for shape, d in (((2, 64, 64, 8), 512), ((2, 64, 64, 512), 4), ((2, 8, 8, 120), 128),
                     ((2, 8, 8, 128), 120), ((2, 8, 4, 128), 128)):
        assert not cv.eligible(shape, d, f32), (shape, d)
    assert cv._pick_block(1536, 512, 128) == 512 and cv._pick_block(640, 512, 128) == 128


def test_task_g_sites_from_the_plan():
    from vitron_tpu_torch.models.diffusion.unet_sd_video import UNetSDVideoConfig, conv3x3_sites

    sites = conv3x3_sites(UNetSDVideoConfig.i2vgen_xl(), 64, 64)
    el = {s for s in sites if cv.eligible((32,) + s[:3], s[3], torch.float32)}
    assert len(el) == 16 and sum(sites.values()) == 49  # 22 res blocks x 2, 3 ups, in, out
    assert set(sites) - el == {(64, 64, 8, 512), (64, 64, 512, 4)}


def test_bias_promotes_as_in_jax():
    """A bf16 conv plus a float32 bias is float32 in both packages (the
    bias is added after the conv)."""
    from vitron_tpu.kernels.conv2d import conv3x3_same as jconv

    x, w, b = _inputs(1, 8, 16, 128, 128, seed=5)
    got = cv.conv3x3_same(_t(x, "bfloat16"), _t(w, "bfloat16"), _t(b))
    want = jconv(_j(x, "bfloat16"), _j(w, "bfloat16"), _j(b), interpret=True)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert _rel(got, want) <= BF16_TOL
    no_bias = cv.conv3x3_same(_t(x, "bfloat16"), _t(w, "bfloat16"))
    assert no_bias.dtype == torch.bfloat16
    assert torch.equal(got, no_bias + _t(b))


@pytest.mark.parametrize("shape", [(1, 6, 8, 128, 128), (2, 4, 8, 128, 256), (1, 8, 8, 16, 32)])
def test_gradients_match_jax_vjp(shape):
    """dx and dw through the port's `Conv3x3` against `jax.vjp` of the
    interpret-mode kernel, with the same cotangent; the last shape is
    ineligible, where JAX's custom VJP still applies (dx by its fallback)."""
    import jax

    from vitron_tpu.kernels.conv2d import conv3x3_same as jconv

    x, w, _ = _inputs(*shape, seed=7)
    g = np.random.RandomState(8).randn(*shape[:3], shape[-1]).astype(np.float32)
    _, vjp = jax.vjp(lambda a, k: jconv(a, k, interpret=True), _j(x), _j(w))
    jdx, jdw = vjp(_j(g))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    cv.conv3x3_same(tx, tw).backward(_t(g))
    assert _rel(tx.grad, jdx) <= F32_TOL
    assert _rel(tw.grad, jdw) <= F32_TOL
    dx, dw = cv.conv3x3_vjp_plain(_t(x), _t(w), _t(g))
    assert torch.equal(dx, tx.grad) and torch.equal(dw, tw.grad)


# shapes the planner meets: task G's four levels (batch 32), the card
# tests' ragged ones, a single image and a row wider than any box
PLANNED = [(32, 64, 64), (32, 32, 32), (32, 16, 16), (32, 8, 8), (3, 5, 8), (1, 9, 24),
           (1, 7, 8), (2, 6, 8), (1, 1, 8), (5, 3, 40), (1, 16, 1024)]


def _coverage(b, h, w, box):
    count = np.zeros((b, h, w), np.int32)
    bb, bh, bw = box
    for b0, h0, w0 in cv.box_tiles(b, h, w, box):
        count[b0:b0 + bb, h0:h0 + bh, w0:w0 + bw] += 1
    return count


@pytest.mark.parametrize("shape", PLANNED)
def test_box_planner_covers_every_pixel_once(shape):
    """The planner's rectangle tiles [B, H, W]: each output pixel in one
    block, the blocks the fewest of any box shape, and the TMA box {64, bw,
    bh, bb} within TMA's limits (each extent <= 256, the inner one 128
    bytes, as the 128-byte swizzle needs)."""
    box = cv.plan_boxes(*shape)
    bb, bh, bw = box
    assert box in cv.BOX_SHAPES and bb * bh * bw == cv.BLOCK_PIXELS
    assert max(64, bw, bh, bb) <= 256 and 64 * 2 == 128
    assert (_coverage(*shape, box) == 1).all()
    n = len(cv.box_tiles(*shape, box))
    assert n == min(len(cv.box_tiles(*shape, other)) for other in cv.BOX_SHAPES)


@pytest.mark.parametrize("box", cv.BOX_SHAPES)
def test_every_box_shape_tiles_a_ragged_shape_once(box):
    assert (_coverage(3, 9, 24, box) == 1).all()


def test_task_g_boxes():
    """Task G's levels take one image's rows whole where W allows."""
    assert [cv.plan_boxes(32, n, n) for n in (64, 32, 16, 8)] == [
        (1, 2, 64), (1, 4, 32), (1, 8, 16), (2, 8, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixel_limit_catches_a_dropped_k_block(dtype):
    """A kernel that skipped one 64-channel block of one tap for one block
    of 128 pixels fails the per-pixel limit; one-ulp flips of a bf16
    output pass it."""
    x, w, _ = _inputs(2, 8, 16, 256, 128, seed=11)
    tx, tw = _t(x, dtype), _t(w, dtype)
    want = cv.conv3x3_plain(tx, tw)
    f32 = torch.float32
    xp = torch.nn.functional.pad(tx.to(torch.bfloat16).to(f32), (0, 0, 1, 1, 1, 1))
    tap = xp[:, 1:9, 2:18, 64:128] @ tw.to(torch.bfloat16).to(f32)[1, 2, 64:128]
    bad = want.to(f32).clone()
    bad[0] -= tap[0]  # the first image's 128 pixels: one block of the kernel
    bad = bad.to(tx.dtype)
    assert chip_smoke.flash_row_rel(bad, want) > chip_smoke.PIXEL_REL[dtype]
    if dtype == "bfloat16":  # one ulp up wherever the plain output is positive
        flip = (want.view(torch.int16) + (want > 0).to(torch.int16)).view(torch.bfloat16)
        assert chip_smoke.flash_row_rel(flip, want) <= chip_smoke.PIXEL_REL[dtype]


def test_bad_shapes_raise():
    with pytest.raises(ValueError):
        cv.conv3x3_same(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError):
        cv.conv3x3_same(torch.zeros(1, 4, 4, 8), torch.zeros(1, 1, 8, 8))


# ---------------------------------------------------------------- the card


def _task_g_sites():
    """The 16 eligible (H, W, C, D) of the i2vgen UNet at 64x64 latents,
    from the block plan."""
    from vitron_tpu_torch.models.diffusion.unet_sd_video import UNetSDVideoConfig, conv3x3_sites

    sites = conv3x3_sites(UNetSDVideoConfig.i2vgen_xl(), 64, 64)
    return sorted(s for s in sites if cv.eligible((32,) + s[:3], s[3], torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", range(16))
def test_kernel_matches_plain_at_the_task_g_sites(cuda, site, dtype):
    h, w, c, d = _task_g_sites()[site]
    g = torch.Generator(device=cuda).manual_seed(site)
    x = torch.randn((32, h, w, c), generator=g, device=cuda).to(dtype)
    k = (torch.randn((3, 3, c, d), generator=g, device=cuda) / (9 * c) ** 0.5).to(dtype)
    before = cv.launches
    got = cv.conv3x3_same(x, k)
    torch.cuda.synchronize()
    assert cv.launches == before + 1 and got.dtype == dtype
    _assert_matches_plain(got, x, k, cv.conv3x3_same(x, k))


def _assert_matches_plain(got, x, k, again):
    """Within the global tolerance and the smoke's per-pixel limit of the
    plain version, and the same bits as a second call."""
    want = cv.conv3x3_plain(x, k)
    name = str(x.dtype).split(".")[-1]
    assert _rel(got, want) <= (F32_TOL if x.dtype == torch.float32 else BF16_TOL)
    assert chip_smoke.flash_row_rel(got, want) <= chip_smoke.PIXEL_REL[name]
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", ELIGIBLE + [(3, 5, 8, 256, 128), (1, 9, 24, 384, 256)])
def test_kernel_matches_plain_at_ragged_shapes(cuda, shape, dtype):
    """M not a multiple of the 128-row tile, row tiles straddling images."""
    b, h, w, c, d = shape
    gen = torch.Generator(device=cuda).manual_seed(h * w)
    x = torch.randn((b, h, w, c), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((3, 3, c, d), generator=gen, device=cuda) * 0.05).to(dtype)
    got = cv.conv3x3_same(x, k)
    torch.cuda.synchronize()
    _assert_matches_plain(got, x, k, cv.conv3x3_same(x, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("box", cv.BOX_SHAPES)
def test_kernel_with_every_box_shape(cuda, box, dtype):
    """Each rectangle the planner may choose, forced on one ragged shape
    (rectangles overrun H, W and B, TMA boxes leave the tensor on every
    side)."""
    gen = torch.Generator(device=cuda).manual_seed(sum(box))
    x = torch.randn((3, 9, 24, 128), generator=gen, device=cuda).to(dtype)
    k = (torch.randn((3, 3, 128, 256), generator=gen, device=cuda) * 0.05).to(dtype)
    got = cv._launch(x, k, box)
    torch.cuda.synchronize()
    _assert_matches_plain(got, x, k, cv._launch(x, k, box))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_gradients_match_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((4, 32, 32, 512), generator=gen, device=cuda).to(dtype).requires_grad_()
    k = (torch.randn((3, 3, 512, 1024), generator=gen, device=cuda) * 0.02).to(
        dtype).requires_grad_()
    y = cv.conv3x3_same(x, k)
    gy = torch.randn(y.shape, generator=gen, device=cuda).to(dtype)
    before = cv.launches
    y.backward(gy)
    torch.cuda.synchronize()
    assert cv.launches == before + 1  # dx through the kernel
    dx, dw = cv.conv3x3_vjp_plain(x.detach(), k.detach(), gy)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _rel(x.grad, dx) <= tol and _rel(k.grad, dw) <= tol


@pytest.mark.cuda
def test_wrapper_routes_by_the_rule_on_the_card(cuda):
    """Ineligible shapes run the exact conv (no launch); a float16 tensor at
    an eligible shape raises (no kernel, no fallback)."""
    x = torch.randn((1, 8, 8, 16), device=cuda)
    k = torch.randn((3, 3, 16, 32), device=cuda)
    before = cv.launches
    got = cv.conv3x3_same(x, k)
    assert cv.launches == before
    assert torch.equal(got, cv.conv3x3_exact(x, k))
    with pytest.raises(NotImplementedError):
        cv.conv3x3_same(torch.randn((1, 8, 8, 128), device=cuda).half(),
                        torch.randn((3, 3, 128, 128), device=cuda).half())
