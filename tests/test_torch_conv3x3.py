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

The `cuda`-marked tests hold the hand kernel against the plain version on
the card at every eligible 3x3 conv of the i2vgen UNet at task G's 64x64
latents (batch 2 x 16 frames; `unet_sd_video.conv3x3_sites`, from the
block plan), float32 and bf16, its gradients against `conv3x3_vjp_plain`, and
check that the wrapper launches the kernel at eligible shapes, runs the
exact conv at the others and raises where it has no kernel.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import conv2d as cv

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
    assert _rel(got, cv.conv3x3_plain(x, k)) <= (F32_TOL if dtype == torch.float32 else BF16_TOL)


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
    assert _rel(got, cv.conv3x3_plain(x, k)) <= (F32_TOL if dtype == torch.float32 else BF16_TOL)


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
