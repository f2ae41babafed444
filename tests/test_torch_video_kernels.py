"""The video slice's kernels: the temporal k=3 conv (B6), per-pixel frame
attention (B7) and the GEGLU feed-forward at the video UNet's widths (B3,
C in {512, 1024, 2048}, F = 4C).

On the CPU the plain versions are held against the JAX kernels run as the
JAX package's own tests run them: `_tconv_pallas(..., interpret=True)` and
the XLA shift-matmul form `_tconv_xla` (through `temporal_conv_k3`),
`_fwd(..., interpret=True)` and the einsum form `_xla` of the frame
attention, and `_xla_geglu` at C = 512. Tolerances are max |port - JAX| /
max |JAX|: 1e-5 in float32 (the order of float32 sums), 2e-2 in bf16 (the
two frameworks round at other places). The `cuda`-marked tests hold each
hand kernel against its plain version on the card at every shape the
task-D path gives it, in float32 and bf16, and check that unsupported
shapes raise. JAX is imported inside the CPU tests only.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import geglu_ff as gf
from vitron_tpu_torch.kernels import temporal_attention as ta
from vitron_tpu_torch.kernels import temporal_conv as tc

F32_TOL, BF16_TOL = 1e-5, 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the hand kernels run only on the card)")
    return torch.device("cuda")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _t(a, dtype="float32"):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _j(a, dtype="float32"):
    import jax.numpy as jnp

    return jnp.asarray(a, getattr(jnp, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------- B6 on the CPU

# (B, F, N, C, Co): ragged N, Co != C, one frame
TCONV_CASES = [(2, 4, 16, 32, 32), (1, 6, 45, 64, 48), (1, 3, 10, 16, 24), (2, 1, 7, 8, 8)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,f,n,c,co", TCONV_CASES)
def test_temporal_conv_plain_matches_pallas_and_xla(b, f, n, c, co, dtype):
    from vitron_tpu.kernels import temporal_conv as jtc

    rs = np.random.RandomState(b * 100 + f * 10 + n)
    x = rs.randn(b, f, n, c).astype(np.float32)
    w = (rs.randn(3, c, co) / np.sqrt(3 * c)).astype(np.float32)
    got = _np(tc.temporal_conv_k3(_t(x, dtype), _t(w, dtype)))
    want_xla = jtc.temporal_conv_k3(_j(x, dtype), _j(w, dtype), use_pallas=False)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert _rel(got, want_xla) <= tol
    if f > 1:  # the Pallas form pads the frame axis; F = 1 only through XLA
        want_pallas = jtc._tconv_pallas(_j(x, dtype), _j(w, dtype), interpret=True)
        assert _rel(got, want_pallas) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_temporal_conv_torch_layout_bias_and_5d_match_jax(dtype):
    """x [B, F, H, W, C], taps in the torch layout [3, 1, C, Co], a bias."""
    from vitron_tpu.kernels import temporal_conv as jtc

    rs = np.random.RandomState(2)
    x = rs.randn(1, 4, 6, 8, 32).astype(np.float32)
    w = (rs.randn(3, 1, 32, 24) * 0.1).astype(np.float32)
    bias = rs.randn(24).astype(np.float32)
    got = tc.temporal_conv_k3(_t(x, dtype), _t(w, dtype), _t(bias, dtype))
    assert tuple(got.shape) == (1, 4, 6, 8, 24) and got.dtype == getattr(torch, dtype)
    want = jtc.temporal_conv_k3(_j(x, dtype), _j(w, dtype), _j(bias, dtype), use_pallas=False)
    assert _rel(_np(got), want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


def test_temporal_conv_rejects_bad_taps():
    x = torch.zeros((1, 2, 3, 8))
    with pytest.raises(ValueError, match=r"\[3, C, Co\]"):
        tc.temporal_conv_k3(x, torch.zeros((2, 8, 8)))
    with pytest.raises(ValueError, match="do not match"):
        tc.temporal_conv_k3(x, torch.zeros((3, 4, 8)))
    with pytest.raises(NotImplementedError, match="W8A8"):
        tc.temporal_conv_k3(x, {"q8t": torch.zeros((3, 8, 8)), "s": torch.ones(8)})


# ---------------------------------------------------------------- B7 on the CPU

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f,heads", [(4, 1), (4, 4), (24, 4)])
def test_frame_attention_plain_matches_pallas_and_xla(f, heads, dtype):
    """The JAX entry folds the scale into q before its kernel; the plain
    version scales the float32 scores: the same function."""
    import jax.numpy as jnp

    from vitron_tpu.kernels import temporal_attention as jta

    d, n, b, scale = 64, 128, 2, 64 ** -0.5
    rs = np.random.RandomState(f + heads)
    q, k, v = (rs.randn(b, f, n, heads * d).astype(np.float32) for _ in range(3))
    got = _np(ta.frame_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype), heads, scale))
    qs = _j(q, dtype) * jnp.asarray(scale, getattr(jnp, dtype))  # as jta.frame_attention
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (jta._xla(qs, _j(k, dtype), _j(v, dtype), heads),
                 jta._fwd(qs, _j(k, dtype), _j(v, dtype), heads=heads, interpret=True)):
        assert _rel(got, want) <= tol


def test_frame_attention_plain_takes_any_pixel_count():
    """N = 45 (the deepest level) and D = 16: the plain version has no tiling
    limits; held against the JAX einsum form."""
    from vitron_tpu.kernels import temporal_attention as jta

    rs = np.random.RandomState(7)
    q, k, v = (rs.randn(1, 5, 45, 32).astype(np.float32) for _ in range(3))
    got = ta.frame_attention(_t(q), _t(k), _t(v), 2, 0.25)
    want = jta._xla(_j(q) * np.float32(0.25), _j(k), _j(v), 2)
    assert _rel(_np(got), want) <= F32_TOL


# ---------------------------------------------------------------- B3 on the CPU

def _geglu_inputs(m, c, f, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, c).astype(np.float32),
            (rs.randn(c, 2 * f) / np.sqrt(c)).astype(np.float32),
            (0.1 * rs.randn(2 * f)).astype(np.float32),
            (rs.randn(f, c) / np.sqrt(f)).astype(np.float32),
            (0.1 * rs.randn(c)).astype(np.float32))


def test_geglu_plain_matches_xla_at_video_width():
    """C = 512, F = 2048 (the video UNet's first level), small M."""
    from vitron_tpu.kernels.geglu_ff import _xla_geglu

    args = _geglu_inputs(40, 512, 2048, seed=3)
    want = _xla_geglu(*(_j(a) for a in args))
    got = gf.geglu_ff(*(_t(a) for a in args))
    assert _rel(_np(got), want) <= F32_TOL


# ---------------------------------------------------------------- on the card

def _video_sites():
    """(N, C, heads) of each UNetSDVideoConfig.t2v() level at 320x576 (40x72
    latents), derived from the block plan by chip_smoke."""
    import chip_smoke
    from vitron_tpu_torch.models.diffusion.unet_sd_video import UNetSDVideoConfig

    return chip_smoke.video_sites(UNetSDVideoConfig.t2v(), 40, 72)


def test_video_sites_from_the_plan():
    assert _video_sites() == [(2880, 512, 8), (720, 1024, 16), (180, 2048, 32),
                              (45, 2048, 32)]


def test_group_norm_shapes_from_the_plan_are_the_paths(monkeypatch):
    """chip_smoke holds B8 on the card at the [B, R, C] shapes it derives
    from the block plan and the VAE config; a tiny t2v UNet call and VAE
    decode give `group_norm_sums` exactly those shapes, as many times."""
    import collections

    import chip_smoke
    from vitron_tpu_torch.models.diffusion import layers, vae
    from vitron_tpu_torch.models.diffusion import unet_sd_video as usv

    seen = []
    real = layers.group_norm_sums

    def record(x3):
        seen.append(tuple(x3.shape))
        return real(x3)

    monkeypatch.setattr(layers, "group_norm_sums", record)
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(0)
    cfg = usv.UNetSDVideoConfig.tiny("t2v")
    params = usv.init_params(g, cfg, cpu)
    x = torch.randn((2, 3, 6, 10, cfg.in_dim), generator=g)
    ctx = torch.randn((2, 5, cfg.context_dim), generator=g)
    usv.forward(params, cfg, x, torch.tensor([10.0, 10.0]), y=ctx)
    assert collections.Counter(seen) == chip_smoke.video_gn_shapes(cfg, 6, 10, 2, 3)
    seen.clear()
    vcfg = vae.VAEConfig.tiny()
    vae.decode(vae.init_params(g, vcfg, cpu), vcfg, torch.randn((3, 6, 10, vcfg.z_channels)))
    assert collections.Counter(seen) == chip_smoke.vae_decode_gn_shapes(vcfg, 6, 10, 3)


def test_group_norm_shapes_at_full_width():
    """Task D's 166 UNet launches and 30 decode launches a call; the shapes
    take both of the kernel's branches (one pass, and rows split over blocks
    with a second pass), up to the decode's [24, 184320, 128]."""
    import chip_smoke
    from vitron_tpu_torch.kernels import group_norm as gn
    from vitron_tpu_torch.models.diffusion.video_pipelines import Text2VideoConfig

    cfg = Text2VideoConfig()
    unet = chip_smoke.video_gn_shapes(cfg.unet, 40, 72, 2, 24)
    dec = chip_smoke.vae_decode_gn_shapes(cfg.vae, 40, 72, 24)
    assert sum(unet.values()) == chip_smoke.video_counts(cfg.unet, 40, 72, 77)["group_norm_sums"]
    assert sum(dec.values()) == chip_smoke.vae_counts(cfg.vae, 2880)[1]["group_norm_sums"]
    assert unet[(48, 2880, 512)] and unet[(2, 24 * 45, 2048)] and dec[(24, 184320, 128)]
    splits = {gn._splits(*s) for s in unet.keys() | dec.keys()}
    assert 1 in splits and max(splits) > 1


def _rel_t(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", range(4))
def test_temporal_conv_kernel_matches_plain_at_the_video_sites(cuda, site, dtype):
    n, c, _ = _video_sites()[site]
    g = torch.Generator(device=cuda).manual_seed(site)
    x = torch.randn((2, 24, n, c), generator=g, device=cuda).to(dtype)
    w = (torch.randn((3, c, c), generator=g, device=cuda) / (3 * c) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn((c,), generator=g, device=cuda)).to(dtype)
    before = tc.launches
    got = tc.temporal_conv_k3(x, w, bias)
    torch.cuda.synchronize()
    assert tc.launches == before + 1
    want = tc.temporal_conv_k3_plain(x, w, bias)
    assert _rel_t(got, want) <= (F32_TOL if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,n,c,co,bias", [(1, 5, 45, 40, 24, True), (2, 1, 33, 8, 16, False),
                                             (3, 7, 130, 64, 136, True), (1, 3, 17, 16, 8, True)])
def test_temporal_conv_kernel_ragged_shapes(cuda, b, f, n, c, co, bias, dtype):
    """Row tiles straddling frames (N not a multiple of the 128-row tile), one
    frame, C not a multiple of the depth step, Co not a multiple of the
    column tile; torch-layout taps. C and Co stay multiples of 8, the only
    widths the kernel takes."""
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((b, f, n, c), generator=g, device=cuda).to(dtype)
    w = torch.randn((3, 1, c, co), generator=g, device=cuda).to(dtype)
    bb = torch.randn((co,), generator=g, device=cuda).to(dtype) if bias else None
    got = tc.temporal_conv_k3(x, w, bb)
    torch.cuda.synchronize()
    assert _rel_t(got, tc.temporal_conv_k3_plain(x, w[:, 0], bb)) <= (
        F32_TOL if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("site", range(4))
def test_frame_attention_kernel_matches_plain_at_the_video_sites(cuda, site, dtype):
    n, c, heads = _video_sites()[site]
    g = torch.Generator(device=cuda).manual_seed(10 + site)
    q, k, v = (torch.randn((2, 24, n, c), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = ta.launches
    got = ta.frame_attention(q, k, v, heads, 64 ** -0.5)
    torch.cuda.synchronize()
    assert ta.launches == before + 1
    want = ta.frame_attention_plain(q, k, v, heads, 64 ** -0.5)
    assert _rel_t(got, want) <= (F32_TOL if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,n,heads,d", [(1, 4, 37, 2, 32), (2, 32, 9, 1, 128),
                                           (1, 1, 5, 3, 64)])
def test_frame_attention_kernel_other_shapes(cuda, b, f, n, heads, d, dtype):
    g = torch.Generator(device=cuda).manual_seed(f * n)
    q, k, v = (torch.randn((b, f, n, heads * d), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    got = ta.frame_attention(q, k, v, heads, d ** -0.5)
    torch.cuda.synchronize()
    want = ta.frame_attention_plain(q, k, v, heads, d ** -0.5)
    assert _rel_t(got, want) <= (F32_TOL if dtype == torch.float32 else 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 45, 180])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("f", [1, 2, 16, 24, 32])
def test_frame_attention_kernel_every_frame_count_and_head_dim(cuda, f, d, n, dtype):
    """Every frame bucket (2 or 4 lanes a key at F <= 16), head dim and a
    pixel count of 1, the same bits on two runs."""
    g = torch.Generator(device=cuda).manual_seed(1000 * f + 10 * d + n)
    q, k, v = (torch.randn((2, f, n, 2 * d), generator=g, device=cuda).to(dtype)
               for _ in range(3))
    before = ta.launches
    got, again = (ta.frame_attention(q, k, v, 2, d ** -0.5) for _ in range(2))
    torch.cuda.synchronize()
    assert ta.launches == before + 2 and torch.equal(got, again)
    want = ta.frame_attention_plain(q, k, v, 2, d ** -0.5)
    assert _rel_t(got, want) <= (F32_TOL if dtype == torch.float32 else 1e-2)


# (M, C) of the video UNet's feed-forward sites (CFG batch 2 x 24 frames) and
# a ragged M
GEGLU_VIDEO_SITES = [(138240, 512), (34560, 1024), (8640, 2048), (2160, 2048), (1001, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,c", GEGLU_VIDEO_SITES)
def test_geglu_kernel_matches_plain_at_video_widths(cuda, m, c, dtype):
    g = torch.Generator(device=cuda).manual_seed(m)
    f = 4 * c
    args = [(torch.randn(s, generator=g, device=cuda) * sc).to(dtype)
            for s, sc in (((m, c), 1.0), ((c, 2 * f), c ** -0.5), ((2 * f,), 0.1),
                          ((f, c), f ** -0.5), ((c,), 0.1))]
    before = gf.launches
    got = gf.geglu_ff(*args)
    torch.cuda.synchronize()
    assert gf.launches == before + 1
    want = gf.geglu_ff_plain(*args)
    # float32: the order of sums; bf16: the rounding of the hidden tensor
    assert _rel_t(got, want) <= (1e-4 if dtype == torch.float32 else 2e-2)


@pytest.mark.cuda
def test_video_kernels_reject_unsupported_shapes(cuda):
    q = torch.zeros((1, 33, 4, 64), device=cuda)
    with pytest.raises(NotImplementedError, match="F=33"):
        ta.frame_attention(q, q, q, 1, 0.125)
    q = torch.zeros((1, 4, 4, 96), device=cuda)
    with pytest.raises(NotImplementedError, match="head dim 96"):
        ta.frame_attention(q, q, q, 1, 0.125)
    with pytest.raises(TypeError, match="float32"):
        h = torch.zeros((1, 4, 4, 64), device=cuda, dtype=torch.float16)
        ta.frame_attention(h, h, h, 1, 0.125)
    x = torch.zeros((1, 2, 3, 8), device=cuda)
    with pytest.raises(NotImplementedError, match="Co=12"):
        tc.temporal_conv_k3(x, torch.zeros((3, 8, 12), device=cuda))
    with pytest.raises(NotImplementedError, match="C=6"):
        tc.temporal_conv_k3(torch.zeros((1, 2, 3, 6), device=cuda),
                            torch.zeros((3, 6, 8), device=cuda))
    with pytest.raises(TypeError, match="float32"):
        tc.temporal_conv_k3(x, torch.zeros((3, 8, 8), device=cuda, dtype=torch.bfloat16))
    x = torch.zeros((4, 6), device=cuda)
    with pytest.raises(NotImplementedError, match="C=6"):
        gf.geglu_ff(x, torch.zeros((6, 48), device=cuda), torch.zeros(48, device=cuda),
                    torch.zeros((24, 6), device=cuda), torch.zeros(6, device=cuda))
    x = torch.zeros((4, 8), device=cuda)
    with pytest.raises(NotImplementedError, match="F=12"):
        gf.geglu_ff(x, torch.zeros((8, 24), device=cuda), torch.zeros(24, device=cuda),
                    torch.zeros((12, 8), device=cuda), torch.zeros(8, device=cuda))
