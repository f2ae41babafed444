"""Parity of the port's vision front (towers, projector, region extractor,
media preprocessing) with the JAX package on the CPU.

Tiny float32 configs; the JAX params are carried across with `from_jax`
and the inputs are numpy arrays from a seeded RandomState. Tolerance
rtol=atol=1e-4 unless stated.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.media import preprocess as tpre
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.vision import projector as tproj
from vitron_tpu_torch.models.vision import region_extractor as treg
from vitron_tpu_torch.models.vision import vit as tvit
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = ATOL = 1e-4


def _tree_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def towers():
    """(JAX vit module, image cfg, video cfg, image params, video params)."""
    import jax

    from vitron_tpu.models.vision import vit as jvit

    icfg = jvit.ViTConfig.tiny()
    vcfg = jvit.ViTConfig.tiny(add_time_attn=True)
    ip = _tree_np(jvit.init_params(jax.random.PRNGKey(0), icfg))
    vp = _tree_np(jvit.init_params(jax.random.PRNGKey(1), vcfg))
    return jvit, icfg, vcfg, ip, vp


def test_forward_features_matches_jax(towers):
    import jax.numpy as jnp

    jvit, icfg, _, ip, _ = towers
    px = np.random.RandomState(0).randn(2, 28, 28, 3).astype(np.float32)
    want = np.asarray(jvit.forward_features(ip, icfg, jnp.asarray(px)))
    got = tvit.forward_features(from_jax(ip, "cpu"), tvit.ViTConfig.tiny(),
                                torch.from_numpy(px))
    assert got.shape == (2, 16, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_forward_video_features_matches_jax(towers):
    """The random temporal tower grows activations to |y| ~ 80, where float32
    rounding alone leaves both packages ~1.5e-3 off a float64 run of the
    port; so the absolute tolerance is 1e-4 of max |y|."""
    import jax.numpy as jnp

    jvit, _, vcfg, _, vp = towers
    px = np.random.RandomState(1).randn(1, 4, 28, 28, 3).astype(np.float32)
    want = np.asarray(jvit.forward_video_features(vp, vcfg, jnp.asarray(px)))
    got = tvit.forward_video_features(from_jax(vp, "cpu"),
                                      tvit.ViTConfig.tiny(add_time_attn=True),
                                      torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("ptype", ["mlp2x_gelu", "linear", "identity"])
def test_projector_matches_jax(ptype):
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.vision import projector as jproj

    params = _tree_np(jproj.init_params(jax.random.PRNGKey(2), 32, 48, ptype))
    x = np.random.RandomState(2).randn(3, 5, 32).astype(np.float32)
    want = np.asarray(jproj.apply(params, jnp.asarray(x)))
    got = tproj.apply(from_jax(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_region_extractor_matches_jax():
    """Boxes straddle patch edges (patch 7 on a 28 image), one is flipped
    (x2 < x1 gives an empty mask), one has fractional corners."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.vision import region_extractor as jreg

    params = _tree_np(jreg.init_params(jax.random.PRNGKey(3), 32, 48))
    feats = np.random.RandomState(3).randn(3, 16, 32).astype(np.float32)
    boxes = np.asarray([[3.5, 2.2, 17.9, 20.1], [6.0, 13.0, 8.0, 15.0],
                        [20.0, 5.0, 4.0, 27.9]], np.float32)
    want = np.asarray(jreg.apply(params, jnp.asarray(feats), jnp.asarray(boxes), image_size=28))
    got = treg.apply(from_jax(params, "cpu"), torch.from_numpy(feats),
                     torch.from_numpy(boxes), image_size=28)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        treg.rasterize_bbox_mask(torch.from_numpy(boxes), 28).numpy(),
        np.asarray(jreg.rasterize_bbox_mask(jnp.asarray(boxes), 28)))


@pytest.mark.parametrize("hw,size", [((336, 448), 224), ((64, 48), 28), ((20, 30), 28)])
def test_preprocess_image_matches_jax(hw, size):
    """jax.image.resize(method="cubic") is Keys a=-0.5 with an antialiased
    (widened) kernel on downscale; the port builds the same weights in
    numpy. Reached: 1.5e-5 absolute on normalized pixels at 336x448 -> 224
    (asserted 1e-4)."""
    import jax.numpy as jnp

    from vitron_tpu.media.preprocess import preprocess_image

    img = np.random.RandomState(4).randint(0, 256, hw + (3,), np.uint8)
    want = np.asarray(preprocess_image(jnp.asarray(img), size=size))
    got = tpre.preprocess_image(img, size=size)
    assert got.shape == (size, size, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_preprocess_video_matches_jax():
    import jax.numpy as jnp

    from vitron_tpu.media.preprocess import preprocess_video, uniform_frame_indices

    frames = np.random.RandomState(5).randint(0, 256, (3, 40, 60, 3), np.uint8)
    want = np.asarray(preprocess_video(jnp.asarray(frames), size=28))
    got = tpre.preprocess_video(frames, size=28)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tpre.uniform_frame_indices(37, 8),
                                  uniform_frame_indices(37, 8))
