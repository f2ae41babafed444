"""Parity of the port's A10 remainder with the JAX package on the CPU: the
Swin, DaViT and ResNet backbones, multi-scale deformable attention, the
deformable pixel decoder, and the WAV decode of `media/asr.py`.

Tiny configs (and DaViT-Tiny's widths at reduced depth), float32. The JAX
params come from the JAX `init_params`, every all-zero leaf (biases, the
deformable attention's offset and weight projections, BatchNorm means) is
filled by `synthetic.fill_zero_leaves`, and the same tree goes to both
packages (at DaViT-Tiny's widths the port's init makes the tree, which
`test_init_trees_match_jax` holds to JAX's). The JAX forwards run under
`jax.jit` (Swin's eagerly). Inputs are numpy arrays from a seeded RandomState. Tolerance:
max |port - jax| <= 1e-4 * max |jax| (RTOL, as the SEEM tests) unless a
test states its own. DaViT's 3x3 depthwise convs take B4's plain version
here, JAX's its XLA form (the JAX package's CPU path). ROADMAP C13: the JAX
`DaViTConfig()` cannot run, the port's (DaViT-Tiny) does.
"""
import wave

import numpy as np
import pytest
import torch

from vitron_tpu_torch.kernels import ms_deform_attn as tmsda
from vitron_tpu_torch.media import asr as tasr
from vitron_tpu_torch.models.convert import from_jax, to_numpy
from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
from vitron_tpu_torch.models.seem import davit as tdavit
from vitron_tpu_torch.models.seem import deform_decoder as tdd
from vitron_tpu_torch.models.seem import resnet as tresnet
from vitron_tpu_torch.models.seem import swin as tswin
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-4


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().numpy(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert rel <= rtol, f"max |port - jax| / max |jax| = {rel:.3e} > {rtol}"


def _live(params, seed):
    """(jnp tree, torch tree) of one live net from a JAX or a port init."""
    import jax
    import jax.numpy as jnp

    if not isinstance(jax.tree.leaves(params)[0], torch.Tensor):
        params = from_jax(jax.tree.map(np.asarray, params), "cpu")
    t = fill_zero_leaves(params, torch.Generator().manual_seed(seed))
    return _tree_map(jnp.asarray, to_numpy(t)), t


def _jit(fn):
    """The JAX forward compiled once (the config static)."""
    import jax

    return jax.jit(fn, static_argnums=1)


def _pixels(seed, hw, b=1):
    return np.random.RandomState(seed).randn(b, *hw, 3).astype(np.float32)


def _maps_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


# ------------------------------------------------------------------- Swin


@pytest.mark.parametrize("hw", [(32, 32), (40, 56)])
def test_swin_matches_jax(hw):
    """32: every map a window multiple; 40x56: 10x14 and 5x7 maps padded to
    12x16 and 8x8 before the partition, shifted blocks with the padded masks.
    (JAX's Swin builds its masks on the host, so it runs eagerly.)"""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.seem import swin as jswin

    cfg = jswin.SwinConfig.tiny()
    jp, tp = _live(jswin.init_params(jax.random.PRNGKey(0), cfg), 1)
    x = _pixels(2, hw)
    want = jswin.forward(jp, cfg, jnp.asarray(x))
    got = tswin.forward(tp, tswin.SwinConfig.tiny(), torch.from_numpy(x))
    _maps_close(got, want)


def test_swin_helpers_match_jax():
    import jax.numpy as jnp

    from vitron_tpu.models.seem import swin as jswin

    np.testing.assert_array_equal(tswin._rel_pos_index(7), jswin._rel_pos_index(7))
    np.testing.assert_array_equal(tswin._attn_mask_for_shift(12, 16, 4, 2),
                                  jswin._attn_mask_for_shift(12, 16, 4, 2))
    x = np.random.RandomState(3).randn(2, 8, 12, 5).astype(np.float32)
    wins = tswin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins.numpy(), jswin.window_partition(jnp.asarray(x), 4))
    np.testing.assert_array_equal(tswin.window_reverse(wins, 4, 8, 12).numpy(), x)


def test_swin_l_config():
    cfg = tswin.SwinConfig.swin_l()
    assert cfg.dims == (192, 384, 768, 1536) and cfg.window_size == 12
    assert cfg.num_heads == (6, 12, 24, 48) and cfg.depths == (2, 2, 18, 2)


# ------------------------------------------------------------------- DaViT


@pytest.mark.parametrize("hw", [(32, 32), (36, 44)])
def test_davit_matches_jax(hw):
    """Tiny DaViT; at 36x44 the 9x11 map is padded to 12x12 windows (a ragged
    window) and the stride-2 embed floors it to 4x5."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.seem import davit as jdavit

    cfg = jdavit.DaViTConfig.tiny()
    jp, tp = _live(jdavit.init_params(jax.random.PRNGKey(4), cfg), 5)
    x = _pixels(6, hw)
    _maps_close(tdavit.forward(tp, tdavit.DaViTConfig.tiny(), torch.from_numpy(x)),
                _jit(jdavit.forward)(jp, cfg, jnp.asarray(x)))


def test_davit_tiny_widths_match_jax():
    """DaViT-Tiny's widths and heads (a config both packages take) at depth
    1 a stage, 64x64: 16/8/4/2-pixel maps padded to the 7x7 window."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.seem import davit as jdavit

    jcfg = jdavit.DaViTConfig(depths=(1, 1, 1, 1), embed_dims=(96, 192, 384, 768))
    cfg = tdavit.DaViTConfig(depths=(1, 1, 1, 1))
    jp, tp = _live(tdavit.init_params(torch.Generator().manual_seed(7), cfg, "cpu"), 8)
    x = _pixels(9, (64, 64))
    got = tdavit.forward(tp, cfg, torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [(1, 16, 16, 96), (1, 8, 8, 192), (1, 4, 4, 384),
                                             (1, 2, 2, 768)]
    _maps_close(got, _jit(jdavit.forward)(jp, jcfg, jnp.asarray(x)))


def test_c13_jax_default_davit_raises_and_the_ports_runs():
    """ROADMAP C13: the JAX default pairs widths 64/128/192/256 with 3/6/12/24
    heads; 64 channels do not split into 3 heads, so its forward raises. The
    port's default is DaViT-Tiny (96/192/384/768) and runs."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.seem import davit as jdavit

    jcfg = jdavit.DaViTConfig()
    jp, _ = _live(tdavit.init_params(torch.Generator().manual_seed(0), tdavit.DaViTConfig(
        embed_dims=jcfg.embed_dims), "cpu"), 1)
    with pytest.raises(TypeError, match="reshape"):
        _jit(jdavit.forward)(jp, jcfg, jnp.zeros((1, 64, 64, 3)))
    cfg = tdavit.DaViTConfig()
    assert cfg.embed_dims == (96, 192, 384, 768)
    assert all(c % h == 0 for c, h in zip(cfg.embed_dims, cfg.num_heads))
    params = tdavit.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    outs = tdavit.forward(params, cfg, torch.from_numpy(_pixels(10, (64, 64))))
    assert [o.shape[-1] for o in outs] == [96, 192, 384, 768]
    assert all(bool(torch.isfinite(o).all()) for o in outs)


# ------------------------------------------------------------------- ResNet


def test_resnet_matches_jax():
    """Frozen-BN bottlenecks (filled BN means), the stem and max pool, the
    stride-2 shortcut; an odd input size."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.seem import resnet as jresnet

    cfg = jresnet.ResNetConfig.tiny(stage_blocks=(2, 1))
    jp, tp = _live(jresnet.init_params(jax.random.PRNGKey(11), cfg), 12)
    x = _pixels(13, (37, 45))
    _maps_close(tresnet.forward(tp, tresnet.ResNetConfig.tiny(stage_blocks=(2, 1)),
                                torch.from_numpy(x)),
                _jit(jresnet.forward)(jp, cfg, jnp.asarray(x)))


def test_resnet_configs():
    """ResNet-50 / -101's stage plans and their init's shortcut convs."""
    assert tresnet.ResNetConfig.resnet50().stage_blocks == (3, 4, 6, 3)
    assert tresnet.ResNetConfig.resnet101().stage_blocks == (3, 4, 23, 3)
    p = tresnet.init_params(torch.Generator().manual_seed(0), tresnet.ResNetConfig.resnet50(),
                            "cpu")
    assert [len(s) for s in p["stages"]] == [3, 4, 6, 3]
    assert ["w_sc" in s[0] and "w_sc" not in s[1] for s in p["stages"]] == [True] * 4
    assert tuple(p["stages"][3][2]["w3"].shape) == (1, 1, 512, 2048)


# ----------------------------------------------------- deformable attention


def test_ms_deform_attn_matches_jax():
    """Three levels, samples inside, on the border and outside each map (the
    zero padding), four heads, three points."""
    import jax.numpy as jnp

    from vitron_tpu.kernels.ms_deform_attn import ms_deform_attn

    shapes = [(6, 7), (3, 4), (2, 2)]
    rs = np.random.RandomState(14)
    s = sum(h * w for h, w in shapes)
    value = rs.randn(2, s, 4, 8).astype(np.float32)
    locs = rs.uniform(-0.2, 1.2, (2, 5, 4, 3, 3, 2)).astype(np.float32)
    weights = rs.rand(2, 5, 4, 3, 3).astype(np.float32)
    want = ms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(weights))
    got = tmsda.ms_deform_attn(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                               torch.from_numpy(weights))
    assert tuple(got.shape) == (2, 5, 32)
    _close(got, want)


def test_ms_deform_attn_is_grid_sample():
    """One level, one head, one point of weight 1: F.grid_sample's bilinear,
    zero-padded, align_corners=False sample."""
    rs = np.random.RandomState(15)
    value = torch.from_numpy(rs.randn(1, 5 * 6, 1, 3).astype(np.float32))
    locs = torch.from_numpy(rs.uniform(-0.3, 1.3, (1, 7, 1, 1, 1, 2)).astype(np.float32))
    got = tmsda.ms_deform_attn(value, [(5, 6)], locs, torch.ones((1, 7, 1, 1, 1)))
    img = value.reshape(1, 5, 6, 3).permute(0, 3, 1, 2)
    grid = (2 * locs - 1).reshape(1, 1, 7, 2)
    want = torch.nn.functional.grid_sample(img, grid, mode="bilinear", padding_mode="zeros",
                                           align_corners=False)[0, :, 0].T
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("levels", ["tiny", "three"])
def test_deform_decoder_matches_jax(levels):
    """`forward_features`: the tiny config (one transformer level, one FPN
    level) and one with two transformer levels over three maps; the mask
    features and the multi-scale maps."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.seem import deform_decoder as jdd

    kw = {} if levels == "tiny" else dict(in_channels=(16, 32, 48), num_transformer_levels=2)
    cfg = jdd.DeformDecoderConfig.tiny(**kw)
    jp, tp = _live(jdd.init_params(jax.random.PRNGKey(16), cfg), 17)
    rs = np.random.RandomState(18)
    feats = [rs.randn(1, 32 >> i, 24 >> i, c).astype(np.float32)
             for i, c in enumerate(cfg.in_channels)]
    jmask, jms = _jit(jdd.forward_features)(jp, cfg, [jnp.asarray(f) for f in feats])
    tmask, tms = tdd.forward_features(tp, tdd.DeformDecoderConfig.tiny(**kw),
                                      [torch.from_numpy(f) for f in feats])
    _close(tmask, jmask)
    _maps_close(tms, jms)


def test_reference_points_match_jax():
    from vitron_tpu.models.seem import deform_decoder as jdd

    np.testing.assert_array_equal(tdd._reference_points([(4, 6), (2, 3)]),
                                  jdd._reference_points([(4, 6), (2, 3)]))


@pytest.mark.parametrize("name", ["swin", "davit", "resnet", "deform_decoder"])
def test_init_trees_match_jax(name):
    """The port's init gives the JAX init's tree, key for key and shape for
    shape (the deformable offsets' ring bias value for value), at configs
    with more than one of each stage kind."""
    import jax

    from vitron_tpu.models.seem import davit as jdavit
    from vitron_tpu.models.seem import deform_decoder as jdd
    from vitron_tpu.models.seem import resnet as jresnet
    from vitron_tpu.models.seem import swin as jswin

    jmod, tmod, kw = {
        "swin": (jswin, tswin, dict(depths=(2, 3), num_heads=(2, 4))),
        "davit": (jdavit, tdavit, dict(depths=(2, 1))),
        "resnet": (jresnet, tresnet, dict(stage_blocks=(2, 2))),
        "deform_decoder": (jdd, tdd, dict(in_channels=(16, 32, 48), num_transformer_levels=2)),
    }[name]
    cfg_name = {"swin": "SwinConfig", "davit": "DaViTConfig", "resnet": "ResNetConfig",
                "deform_decoder": "DeformDecoderConfig"}[name]
    jp = jmod.init_params(jax.random.PRNGKey(0), getattr(jmod, cfg_name).tiny(**kw))
    tp = tmod.init_params(torch.Generator().manual_seed(0), getattr(tmod, cfg_name).tiny(**kw),
                          "cpu")
    assert _tree_map(lambda t: tuple(t.shape), tp) == _tree_map(lambda a: tuple(a.shape), jp)
    if name == "deform_decoder":
        np.testing.assert_allclose(tp["layers"][1]["attn"]["off_b"].numpy(),
                                   np.asarray(jp["layers"][1]["attn"]["off_b"]))


# ------------------------------------------------------------------- audio


def _write_wav(path, data: np.ndarray, width: int, rate: int):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(data.shape[1])
        f.setsampwidth(width)
        f.setframerate(rate)
        f.writeframes(data.tobytes())


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate", [16000, 44100])
def test_load_audio_matches_jax(tmp_path, width, channels, rate):
    """8-bit unsigned, 16- and 32-bit signed PCM, mono and stereo, at 16 kHz
    and resampled from 44.1 kHz: the same samples as the JAX package's
    decode."""
    from vitron_tpu.media import asr as jasr

    rs = np.random.RandomState(width * 10 + channels)
    n = rate // 20
    dtype = {1: np.uint8, 2: "<i2", 4: "<i4"}[width]
    info = np.iinfo(np.dtype(dtype))
    data = rs.randint(info.min, int(info.max) + 1, (n, channels), dtype=np.int64).astype(dtype)
    path = tmp_path / f"a{width}{channels}{rate}.wav"
    _write_wav(path, data, width, rate)
    got = tasr.load_audio(str(path))
    want = jasr.load_audio(str(path))
    assert got.dtype == np.float32 and got.ndim == 1
    assert len(got) == (n if rate == 16000 else int(round(n * 16000 / rate)))
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(got).max()) <= 1.0
