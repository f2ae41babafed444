"""Parity of the port's A9 remainder with the JAX package on the CPU: eps
DDIM, DPM-Solver++(2M), `cfg_eps`, the text + image PositionNet, CLIP's
pooled image embedding, the style pipeline (`GligenStylePipeline`), the
grounding nets (ConvNeXt-T, the hint and keypoint PositionNets, the
downsamplers) and the hint resizes.

Tiny configs, float32. JAX params are made by the JAX init (or the port's,
for the nets whose init is new in the port), carried across with `from_jax`
/ `to_numpy`, and every all-zero leaf is filled by
`synthetic.fill_zero_leaves` so that no check passes on a zero output; the
ConvNeXt layerscale gammas (1e-6 at init) are drawn from U(0.5, 1.5).
Noise that JAX draws from its keys is drawn here from the same keys and
handed to the port. Inputs are numpy arrays from a seeded RandomState.
Tolerance: max |port - jax| <= 1e-4 * max |jax| (RTOL) unless a test states
its own; images within 1 uint8 level. The JAX ConvNeXt runs under
`jax.jit`. The resizes are held at sizes that
are not the identity (300x260 to 448 nearest and to 256 cubic).
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.media import preprocess as tpre
from vitron_tpu_torch.models.convert import from_jax, to_numpy
from vitron_tpu_torch.models.diffusion import gligen_pipeline as tgp
from vitron_tpu_torch.models.diffusion import grounding_nets as tgn
from vitron_tpu_torch.models.diffusion import layers as tl
from vitron_tpu_torch.models.diffusion import samplers as tsamp
from vitron_tpu_torch.models.diffusion import unet2d as tunet
from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
from vitron_tpu_torch.models.vision import vit as tvit
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-4


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _rel(got, want):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _close(got, want, rtol=RTOL):
    rel = _rel(got, want)
    assert rel <= rtol, f"max |port - jax| / max |jax| = {rel:.3e} > {rtol}"


def _live(jax_params, seed):
    """(jnp tree, torch tree) of one live net made by a JAX init."""
    import jax

    t = fill_zero_leaves(from_jax(jax.tree.map(np.asarray, jax_params), "cpu"),
                         torch.Generator().manual_seed(seed))
    return _to_jax(t), t


def _to_jax(tree):
    import jax.numpy as jnp

    return _tree_map(jnp.asarray, to_numpy(tree))


# ---------------------------------------------------------------- samplers


def _eps_pair():
    """The same toy denoiser for both packages: eps(x, t, gate)."""
    import jax.numpy as jnp

    def jeps(x, t, gate):
        return 0.3 * x * gate + jnp.sin(x + t / 250.0) * 0.2

    def teps(x, t, gate):
        return 0.3 * x * gate + torch.sin(x + t / 250.0) * 0.2

    return jeps, teps


def _sched():
    return tsamp.DiffusionSchedule.create("linear", 1000, 0.00085, 0.012)


@pytest.mark.parametrize("case", ["eta0", "eta1", "mask_blend"])
def test_ddim_sample_matches_jax(case):
    """eps DDIM at eta 0, at eta 1 with the noise JAX draws from its step keys,
    and with the inpainting composite (its re-noise from the same keys),
    over a gate schedule."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import samplers as jsamp

    steps, shape = 10, (1, 8, 8, 4)
    rs = np.random.RandomState(1)
    x = rs.randn(*shape).astype(np.float32)
    gates = jsamp.alpha_generator(steps, (0.3, 0.3, 0.4))
    eta = 0.0 if case == "eta0" else 1.0
    rng = jax.random.PRNGKey(7)
    blend = None
    kw = {}
    if case == "mask_blend":
        mask = (rs.rand(1, 8, 8, 1) > 0.5).astype(np.float32)
        x0 = rs.randn(*shape).astype(np.float32)
        blend = (jnp.asarray(mask), jnp.asarray(x0))
        kw["mask_blend"] = (torch.from_numpy(mask), torch.from_numpy(x0))
    jeps, teps = _eps_pair()
    want = jsamp.ddim_sample(jeps, jnp.asarray(x), jsamp.DiffusionSchedule.create(
        "linear", 1000, 0.00085, 0.012), steps, rng=rng, eta=eta, gate_alphas=gates,
        mask_blend=blend)
    noise, renoise = [], []
    for key in jax.random.split(rng, steps):  # the JAX step body's draws
        if case == "mask_blend":
            k1, key = jax.random.split(key)
            renoise.append(np.asarray(jax.random.normal(k1, shape)))
        noise.append(np.asarray(jax.random.normal(key, shape)))
    if case != "eta0":
        kw["noise"] = torch.from_numpy(np.stack(noise))
    if renoise:
        kw["blend_noise"] = torch.from_numpy(np.stack(renoise))
    got = tsamp.ddim_sample(teps, torch.from_numpy(x), _sched(), steps, eta=eta,
                            gate_alphas=gates, **kw)
    _close(got, want)


def test_ddim_sample_draws_from_the_generator():
    """Without given noise, eta > 0 draws each step's noise from `gen`: the
    same seed gives the same latent, another seed another."""
    _, teps = _eps_pair()
    x = torch.from_numpy(np.random.RandomState(2).randn(1, 8, 8, 4).astype(np.float32))

    def run(seed):
        return tsamp.ddim_sample(teps, x, _sched(), 5, eta=1.0,
                                 gen=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


@pytest.mark.parametrize("steps", [10, 25])
def test_dpm_solver_pp_2m_matches_jax(steps):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import samplers as jsamp

    x = np.random.RandomState(3).randn(1, 8, 8, 4).astype(np.float32)
    gates = jsamp.alpha_generator(steps, (0.5, 0.2, 0.3))
    jeps, teps = _eps_pair()
    want = jsamp.dpm_solver_pp_2m(jeps, jnp.asarray(x), jsamp.DiffusionSchedule.create(
        "linear", 1000, 0.00085, 0.012), steps, gate_alphas=gates)
    got = tsamp.dpm_solver_pp_2m(teps, torch.from_numpy(x), _sched(), steps, gate_alphas=gates)
    assert bool(torch.isfinite(got).all())
    _close(got, want)


@pytest.mark.parametrize("scale", [1.0, 7.5])
def test_cfg_eps_matches_jax(scale):
    """One batched cond + uncond call: the context pair, a batched keyword
    tensor doubled, a scalar one passed as it is."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import samplers as jsamp

    rs = np.random.RandomState(4)
    x, ctx, uc, extra = (rs.randn(*s).astype(np.float32)
                         for s in ((2, 4, 4, 3), (2, 5, 3), (2, 5, 3), (2, 4, 4, 3)))

    def jmodel(x, t, c, gate, extra=None, bias=0.0):
        return x * c.mean(axis=(1, 2))[:, None, None, None] \
            + jnp.reshape(jnp.asarray(t), (-1, 1, 1, 1)) / 100 + gate * extra + bias

    def tmodel(x, t, c, gate, extra=None, bias=0.0):
        return x * c.mean(dim=(1, 2))[:, None, None, None] \
            + torch.as_tensor(t).reshape(-1, 1, 1, 1) / 100 + gate * extra + bias

    want = jsamp.cfg_eps(jmodel, scale)(jnp.asarray(x), jnp.asarray(301), jnp.asarray(ctx),
                                        jnp.asarray(uc), 0.7, extra=jnp.asarray(extra), bias=0.25)
    got = tsamp.cfg_eps(tmodel, scale)(torch.from_numpy(x), 301, torch.from_numpy(ctx),
                                       torch.from_numpy(uc), 0.7, extra=torch.from_numpy(extra),
                                       bias=0.25)
    _close(got, want)


# ------------------------------------------------------- style pipeline parts


def test_position_net_with_image_matches_jax():
    """The port's init (published widths scaled to the tiny context) with
    every null embedding filled; slots with text only, image only, both and
    neither."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion.layers import position_net_with_image

    ucfg = tunet.UNetConfig.tiny()
    tp = fill_zero_leaves(tunet.init_position_net_with_image(torch.Generator().manual_seed(0),
                                                             ucfg, "cpu"),
                          torch.Generator().manual_seed(1))
    assert tuple(tp["text"]["w0"].shape) == (ucfg.context_dim + 64, 512)
    rs = np.random.RandomState(5)
    boxes = rs.rand(2, 6, 4).astype(np.float32)
    masks = np.array([[1, 1, 1, 1, 0, 0], [1, 0, 1, 1, 1, 0]], np.float32)
    tmask = masks * np.array([1, 0, 1, 0, 1, 1], np.float32)
    imask = masks * np.array([1, 1, 0, 0, 1, 0], np.float32)
    temb, iemb = (rs.randn(2, 6, ucfg.context_dim).astype(np.float32) for _ in range(2))
    args = (boxes, masks, tmask, imask, temb, iemb)
    want = position_net_with_image(_to_jax(tp), *(jnp.asarray(a) for a in args))
    got = tl.position_net_with_image(tp, *(torch.from_numpy(a) for a in args))
    assert tuple(got.shape) == (2, 12, ucfg.context_dim)
    _close(got, want)


def test_published_position_net_with_image_widths():
    """SD v1.4's with-image net: 768 + 64 -> 512 -> 512 -> 768 a branch."""
    p = tunet.init_position_net_with_image(torch.Generator().manual_seed(0),
                                           tunet.UNetConfig.sd_v1(), "meta")
    for branch in ("text", "image"):
        assert [tuple(p[branch][k].shape) for k in ("w0", "w1", "w2")] == [
            (832, 512), (512, 512), (512, 768)]
    assert tuple(p["null_position"].shape) == (64,)


def _vision(seed=0):
    import jax

    from vitron_tpu.models.vision import vit as jvit

    cfg = jvit.ViTConfig.tiny(hidden_size=24, num_heads=4)
    jp, tp = _live(jvit.init_params(jax.random.PRNGKey(seed), cfg), seed + 10)
    return cfg, jp, tp


def test_forward_pooled_matches_jax():
    """Every layer runs (select_layer does not stop it), then the post-LN CLS
    token and the visual projection."""
    import jax.numpy as jnp

    from vitron_tpu.models.vision import vit as jvit

    jcfg, jp, tp = _vision()
    tcfg = tvit.ViTConfig.tiny(hidden_size=24, num_heads=4)
    rs = np.random.RandomState(6)
    px = rs.randn(2, 28, 28, 3).astype(np.float32)
    proj = (rs.randn(24, 16) * 0.2).astype(np.float32)
    want = jvit.forward_pooled(jp, jcfg, jnp.asarray(px), jnp.asarray(proj))
    got = tvit.forward_pooled(tp, tcfg, torch.from_numpy(px), torch.from_numpy(proj))
    _close(got, want)
    _close(tvit.forward_pooled(tp, tcfg, torch.from_numpy(px)),
           jvit.forward_pooled(jp, jcfg, jnp.asarray(px)))


def test_reproject_image_feature_matches_jax():
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion.gligen_pipeline import reproject_image_feature

    rs = np.random.RandomState(7)
    f, m = rs.randn(3, 16).astype(np.float32), rs.randn(16, 16).astype(np.float32)
    got = tgp.reproject_image_feature(torch.from_numpy(f), torch.from_numpy(m))
    np.testing.assert_allclose(torch.linalg.vector_norm(got, dim=-1).numpy(), 28.7, rtol=1e-6)
    _close(got, reproject_image_feature(jnp.asarray(f), jnp.asarray(m)))


@pytest.fixture(scope="module")
def style_pipelines():
    """(JAX, port) GligenStylePipeline on the same live tiny nets: a grounded
    UNet whose position net is the with-image one, the SD VAE, CLIP text, a
    tiny CLIP vision tower with its projection, GLIGEN's projection matrix."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import clip_text, gligen_pipeline as jgp, unet2d, vae

    cfg = jgp.GligenConfig.tiny()
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    _, unet = _live(unet2d.init_params(ks[0], cfg.unet), 1)
    unet = {**unet, "position_net": fill_zero_leaves(
        tunet.init_position_net_with_image(torch.Generator().manual_seed(2),
                                           tunet.UNetConfig.tiny(), "cpu"),
        torch.Generator().manual_seed(3))}
    _, vae_p = _live(vae.init_params(ks[1], cfg.vae), 4)
    _, text = _live(clip_text.init_params(ks[2], cfg.text), 5)
    vcfg, jvis, tvis = _vision(6)
    rs = np.random.RandomState(8)
    vproj = (rs.randn(24, 16) * 0.2).astype(np.float32)
    projm = (rs.randn(16, 16) * 0.2).astype(np.float32)
    tok = StubClipTokenizer(cfg.text.vocab_size)
    jpipe = jgp.GligenStylePipeline(cfg, _to_jax(unet), _to_jax(vae_p), _to_jax(text),
                                    vision_params=jvis, vision_cfg=vcfg,
                                    visual_proj=jnp.asarray(vproj),
                                    projection_matrix=jnp.asarray(projm), tokenizer=tok)
    tpipe = tgp.GligenStylePipeline(tgp.GligenConfig.tiny(), unet, vae_p, text,
                                    vision_params=tvis,
                                    vision_cfg=tvit.ViTConfig.tiny(hidden_size=24, num_heads=4),
                                    visual_proj=torch.from_numpy(vproj),
                                    projection_matrix=torch.from_numpy(projm), tokenizer=tok)
    return jpipe, tpipe


STYLE = ("a vase and a cup in this style", [[0.2, 0.2, 0.8, 0.8], [0.1, 0.5, 0.4, 0.9],
                                            [0.6, 0.1, 0.9, 0.3]], ["a vase", "a cup"])


def test_style_grounding_tokens_match_jax(style_pipelines):
    """Three boxes, two phrases and one style crop: slot i takes phrase and
    image min(i, n - 1), as JAX fills them; image features have norm 28.7."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion.layers import position_net_with_image

    jpipe, tpipe = style_pipelines
    prompt, boxes, phrases = STYLE
    style = np.random.RandomState(9).rand(1, 28, 28, 3).astype(np.float32)
    inputs = tpipe.prepare_styled(prompt, boxes, phrases, style, has_image_mask=1.0)
    assert inputs["phrase_slot"][:3].tolist() == [0, 1, 1]
    assert inputs["image_slot"][:3].tolist() == [0, 0, 0]
    feats = tpipe.image_features(torch.from_numpy(style))
    np.testing.assert_allclose(torch.linalg.vector_norm(feats, dim=-1).numpy(), 28.7, rtol=1e-5)
    _close(feats, jpipe.image_features(jnp.asarray(style)))
    got = tpipe.grounding_tokens_styled(**{k: v for k, v in inputs.items()
                                           if k not in ("ids_ctx", "ids_uc")})
    mo, cd = 4, 16
    pooled_t = np.asarray(jpipe.pooled_text_features(jpipe.tokenize(phrases)))
    pooled_i = np.asarray(jpipe.image_features(jnp.asarray(style)))
    gb, gm = np.zeros((mo, 4), np.float32), np.zeros((mo,), np.float32)
    gt, gi = np.zeros((mo, cd), np.float32), np.zeros((mo, cd), np.float32)
    for i in range(3):  # generate_styled's fill
        gb[i], gm[i] = boxes[i], 1.0
        gt[i], gi[i] = pooled_t[min(i, 1)], pooled_i[0]
    want = position_net_with_image(jpipe.unet_params["position_net"], *(
        jnp.asarray(a)[None] for a in (gb, gm, gm, gm, gt, gi)))
    _close(got, want)


@pytest.mark.parametrize("masks", [(1.0, 1.0), (1.0, 0.0)])
def test_style_run_matches_jax_generate_styled(style_pipelines, masks):
    """`run_styled` given the x_T that JAX's generate_styled draws from its
    key gives JAX's image to within 1 uint8 level (4 PLMS steps, guidance
    7.5); with has_image_mask 0 the image branch takes the null feature."""
    import jax

    jpipe, tpipe = style_pipelines
    prompt, boxes, phrases = STYLE
    style = np.random.RandomState(10).rand(2, 28, 28, 3).astype(np.float32)
    cfg = tpipe.cfg
    want = np.asarray(jpipe.generate_styled(prompt, boxes, phrases, jax.numpy.asarray(style),
                                            has_text_mask=masks[0], has_image_mask=masks[1],
                                            rng=jax.random.PRNGKey(1), steps=4))
    _, k = jax.random.split(jax.random.PRNGKey(1))
    x_t = torch.from_numpy(np.array(jax.random.normal(
        k, (1, cfg.latent_size, cfg.latent_size, cfg.unet.out_channels))))
    inputs = tpipe.prepare_styled(prompt, boxes, phrases, style, *masks)
    got = tpipe.run_styled(**inputs, x_t=x_t, steps=4, guidance_scale=7.5,
                           alpha_type=(0.3, 0.0, 0.7)).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (32, 32, 3)
    assert int(want.max()) != int(want.min())
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_generate_styled_draws_x_t_from_the_generator(style_pipelines):
    _, tpipe = style_pipelines
    prompt, boxes, phrases = STYLE
    style = np.random.RandomState(11).rand(1, 28, 28, 3).astype(np.float32)

    def run(seed):
        return tpipe.generate_styled(prompt, boxes, phrases, style, steps=2,
                                     gen=torch.Generator().manual_seed(seed))

    a = run(0)
    assert a.shape == (32, 32, 3) and a.dtype == torch.uint8
    assert torch.equal(a, run(0))


# ------------------------------------------------------------ grounding nets


@pytest.mark.parametrize("method,size", [("nearest", 448), ("cubic", 256), ("nearest", 64),
                                         ("cubic", 64)])
def test_hint_resize_matches_jax_off_the_identity(method, size):
    """300x260 maps resized as the grounding nets resize hints, against
    jax.image.resize (antialias off): the same indices and weights."""
    import jax
    import jax.numpy as jnp

    x = np.random.RandomState(12).rand(1, 300, 260, 3).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (1, size, size, 3), method=method, antialias=False)
    got = tpre._resize_hw(torch.from_numpy(x), size, size, method, antialias=False)
    _close(got, want, rtol=1e-6)


def _gammas_live(tree, seed):
    """ConvNeXt layerscale gammas from U(0.5, 1.5): at 1e-6 the blocks vanish."""
    g = torch.Generator().manual_seed(seed)
    for stage in tree["convnext"]["stages"]:
        for blk in stage:
            blk["gamma"] = 0.5 + torch.rand(blk["gamma"].shape, generator=g)
    return tree


@pytest.fixture(scope="module")
def hint_nets():
    """(jnp, torch) hint PositionNets at resize_input 64: the canny / depth /
    hed / normal form and the sem form (5 class channels). The port's init
    makes them; its tree is JAX's init tree, key for key and shape for shape
    (`jax.eval_shape`, which runs no init)."""
    import jax

    from vitron_tpu.models.diffusion import grounding_nets as jgn

    out = {}
    for name, in_dim, seed in (("hint", 0, 0), ("sem", 5, 1)):
        t = tgn.init_hint_position_net(torch.Generator().manual_seed(seed), "cpu",
                                       resize_input=64, out_dim=48, in_dim=in_dim)
        jshapes = jax.eval_shape(lambda k: jgn.init_hint_position_net(
            k, resize_input=64, out_dim=48, in_dim=in_dim), jax.random.PRNGKey(0))
        assert _tree_map(lambda a: tuple(a.shape), t) == _tree_map(lambda a: a.shape, jshapes)
        t = _gammas_live(fill_zero_leaves(t, torch.Generator().manual_seed(seed + 20)), seed + 30)
        out[name] = (_to_jax(t), t)
    return out


def _jit(fn, **static):
    import jax

    return jax.jit(fn, static_argnames=tuple(static)) if static else jax.jit(fn)


@pytest.mark.parametrize("name,hw", [("hint", (64, 64)), ("hint", (75, 93)), ("sem", (64, 64)),
                                     ("sem", (90, 70))])
def test_hint_position_net_matches_jax(hint_nets, name, hw):
    """The hint net (ConvNeXt-T trunk, B4's plain version at 7x7) with one
    masked map, at the identity resize and at a nearest resize to 64."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import grounding_nets as jgn

    jp, tp = hint_nets[name]
    channels = 5 if name == "sem" else 3
    rs = np.random.RandomState(13)
    hint = rs.rand(2, *hw, channels).astype(np.float32)
    mask = np.array([1.0, 0.0], np.float32)
    want = _jit(jgn.position_net_hint, resize_input=64)(jp, jnp.asarray(hint), jnp.asarray(mask),
                                                       resize_input=64)
    got = tgn.position_net_hint(tp, torch.from_numpy(hint), torch.from_numpy(mask),
                                resize_input=64)
    assert tuple(got.shape) == (2, 4, 48)
    _close(got, want)


def test_convnext_forward_matches_jax(hint_nets):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import grounding_nets as jgn

    jp, tp = hint_nets["hint"]
    x = np.random.RandomState(14).randn(1, 96, 64, 3).astype(np.float32)
    want = _jit(jgn.convnext_forward)(jp["convnext"], jnp.asarray(x))
    got = tgn.convnext_forward(tp["convnext"], torch.from_numpy(x))
    assert tuple(got.shape) == (1, 3, 2, 768)
    _close(got, want)


def test_keypoint_position_net_matches_jax():
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import grounding_nets as jgn

    jp, tp = _live(jgn.init_keypoint_position_net(jax.random.PRNGKey(2), max_persons=3,
                                                  out_dim=48), 40)
    rs = np.random.RandomState(15)
    points = rs.rand(2, 3 * 17, 2).astype(np.float32)
    masks = (rs.rand(2, 3 * 17) > 0.3).astype(np.float32)
    want = jgn.position_net_keypoint(jp, jnp.asarray(points), jnp.asarray(masks))
    got = tgn.position_net_keypoint(tp, torch.from_numpy(points), torch.from_numpy(masks))
    _close(got, want)


def _downsampler(seed, cin):
    rs = np.random.RandomState(seed)
    return {"conv1_w": (rs.randn(3, 3, cin, 8) / np.sqrt(9 * cin)).astype(np.float32),
            "conv1_b": (rs.randn(8) * 0.1).astype(np.float32),
            "conv2_w": (rs.randn(3, 3, 8, 4) / np.sqrt(72)).astype(np.float32),
            "conv2_b": (rs.randn(4) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("kind,cin,kwargs,hw", [
    ("canny", 3, dict(grayscale=True, mode="bicubic"), (32, 32)),
    ("canny", 3, dict(grayscale=True, mode="bicubic"), (300, 260)),
    ("normal", 3, dict(grayscale=False, mode="bicubic"), (45, 50)),
    ("sem", 12, dict(grayscale=False, mode="nearest"), (32, 32)),
    ("sem", 12, dict(grayscale=False, mode="nearest"), (300, 260)),
])
def test_grounding_downsampler_matches_jax(kind, cin, kwargs, hw):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import grounding_nets as jgn

    p = _downsampler(16, 1 if kwargs["grayscale"] else cin)
    hint = np.random.RandomState(17).rand(1, *hw, cin).astype(np.float32)
    want = jgn.grounding_downsampler({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(hint), resize_input=32, **kwargs)
    got = tgn.grounding_downsampler({k: torch.from_numpy(v) for k, v in p.items()},
                                    torch.from_numpy(hint), resize_input=32, **kwargs)
    assert tuple(got.shape) == (1, 8, 8, 4)
    _close(got, want)


@pytest.mark.parametrize("hw", [(64, 64), (300, 260)])
def test_hed_downsampler_matches_jax(hw):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import grounding_nets as jgn

    hint = np.random.RandomState(18).rand(1, *hw, 3).astype(np.float32)
    _close(tgn.grounding_downsampler_hed(torch.from_numpy(hint)),
           jgn.grounding_downsampler_hed(jnp.asarray(hint)), rtol=1e-6)


def test_published_hint_net_shapes():
    """At the published resize_input 448: 196 tokens of ConvNeXt-T's 768
    channels into the 512-wide MLP; the keypoint net at 8 persons."""
    p = tgn.init_hint_position_net(torch.Generator().manual_seed(0), "meta", in_dim=182)
    assert tuple(p["pos_embedding"].shape) == (1, 196, 768)
    assert tuple(p["linears"]["w0"].shape) == (768, 512)
    assert tuple(p["in_conv"]["w"].shape) == (3, 3, 182, 3)
    assert [len(s) for s in p["convnext"]["stages"]] == [3, 3, 9, 3]
    k = tgn.init_keypoint_position_net(torch.Generator().manual_seed(0), "meta")
    assert tuple(k["person_embeddings"].shape) == (8, 768)
    assert tuple(k["linears"]["w0"].shape) == (800, 512)
