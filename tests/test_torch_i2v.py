"""Parity of the port's image-to-video slice (task G) with the JAX package on
the CPU: the i2vgen video UNet's own pieces (`adaptive_avg_pool2d`,
`transformer_v2`), its `forward` at `UNetSDVideoConfig.tiny("i2vgen")` with
and without the global image embedding, its `init_params` tree, the I2V
pipeline's device half on JAX's x_T and `handle_g` through
`VitronSystem.route`; and the two reference faults the port fixes on its
side: a non-square request image (C7: JAX raises, the port resizes) and a
step count that does not divide 1000 (C6: JAX gives NaN, the port raises).

The JAX params come from the JAX `init_params`, are carried across with
`from_jax` (the list-of-dicts `local_temporal` included), and every all-zero
leaf is filled by `synthetic.fill_zero_leaves`; the filled tree goes back to
JAX, so both packages hold the same live net. Inputs are numpy arrays from a
seeded RandomState. Tolerances, max |port - JAX| / max |JAX|: 1e-5 for a
module in float32, 1e-3 for the whole UNet and the DDIM latent (the order of
float32 sums through ~20 layers); frames agree to within 1 uint8 level.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion import clip_text as tct
from vitron_tpu_torch.models.diffusion import samplers as tsamp
from vitron_tpu_torch.models.diffusion import unet_sd_video as tusv
from vitron_tpu_torch.models.diffusion import video_pipelines as tvp
from vitron_tpu_torch.models.diffusion.synthetic import (StubClipTokenizer, StubImageEmbedder,
                                                         fill_zero_leaves)
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODULE_TOL, UNET_TOL = 1e-5, 1e-3
PROMPT = "a kite flying over the sea"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _live(jax_params, seed):
    """(JAX tree, port tree) of one live net: zero leaves filled on the port
    side and carried back."""
    import jax
    import jax.numpy as jnp

    t = fill_zero_leaves(from_jax(jax.tree.map(np.asarray, jax_params), "cpu"),
                         torch.Generator().manual_seed(seed))
    return _tree_map(lambda a: jnp.asarray(a.numpy()), t), t


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _x(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def unet():
    """(config, (JAX params, port params)) at tiny("i2vgen")."""
    import jax

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg = jusv.UNetSDVideoConfig.tiny("i2vgen")
    return cfg, _live(jusv.init_params(jax.random.PRNGKey(4), cfg), 30)


# ---------------------------------------------------------------- pieces


@pytest.mark.parametrize("hw,out", [((8, 8), (32, 32)), ((13, 13), (5, 5)), ((32, 32), (32, 32)),
                                    ((7, 9), (3, 4)), ((5, 6), (8, 11))])
def test_adaptive_avg_pool2d_matches_jax(hw, out):
    """Downsampling with uneven bins, the identity, and upsampling (the
    tiny config's 8 -> 32, overlapping bins)."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    x = _x(np.random.RandomState(hw[0]), 2, *hw, 3)
    got = tusv.adaptive_avg_pool2d(torch.from_numpy(x), out)
    want = jusv.adaptive_avg_pool2d(jnp.asarray(x), out)
    assert _rel(got, want) <= MODULE_TOL


@pytest.mark.parametrize("side", [32, 64, 128])
def test_equal_window_pooling_matches_adaptive_and_jax(side):
    """At the i2vgen sides that divide by 32 (task G's 64, the training
    step's 32) `adaptive_avg_pool2d` pools with `avg_pool2d` at kernel =
    stride (ROADMAP C15): held against `F.adaptive_avg_pool2d`, the form it
    replaces, and JAX's integral-image form."""
    import jax.numpy as jnp
    import torch.nn.functional as F

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    x = _x(np.random.RandomState(side), 2, side, side, 5)
    got = tusv.adaptive_avg_pool2d(torch.from_numpy(x), (32, 32))
    before = F.adaptive_avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), (32, 32))
    assert _rel(got, before.permute(0, 2, 3, 1)) <= 1e-6
    assert _rel(got, jusv.adaptive_avg_pool2d(jnp.asarray(x), (32, 32))) <= MODULE_TOL


def test_transformer_v2_matches_jax(unet):
    """The adapter transformer over (b h w) sequences of frames, 2 heads of
    dim_head = concat_dim, on the fixture's live `local_temporal` layers."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg, (jp, tp) = unet
    cd = cfg.concat_dim
    x = _x(np.random.RandomState(1), 6, 5, cd)
    got = tusv.transformer_v2(tp["local_temporal"], torch.from_numpy(x), 2, cd)
    want = jusv.transformer_v2(jp["local_temporal"], jnp.asarray(x), heads=2, dim_head=cd)
    assert _rel(got, want) <= MODULE_TOL


def test_block_plan_and_config_match_jax():
    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    for name in ("i2vgen_xl",):
        t, j = getattr(tusv.UNetSDVideoConfig, name)(), getattr(jusv.UNetSDVideoConfig, name)()
        assert tusv.block_plan(t) == jusv.block_plan(j)
        assert t.concat_dim == j.concat_dim == 4
    assert tusv.block_plan(tusv.UNetSDVideoConfig.tiny("i2vgen")) == \
        jusv.block_plan(jusv.UNetSDVideoConfig.tiny("i2vgen"))
    # conv_in takes the latent and the concat stream: 8 -> 512
    assert tusv.block_plan(tusv.UNetSDVideoConfig.i2vgen_xl())[0][0][0] == ("conv_in", 8, 512)


def _inputs(cfg, frames, seed):
    rs = np.random.RandomState(seed)
    return dict(x=_x(rs, 2, frames, 8, 8, cfg.in_dim), t=np.asarray([501.0, 17.0], np.float32),
                y=_x(rs, 2, 5, cfg.context_dim), fps=np.asarray([16.0, 8.0], np.float32),
                image=_x(rs, 2, cfg.y_dim), local_image=_x(rs, 2, 8, 8, cfg.in_dim))


@pytest.mark.parametrize("with_image,frames", [(True, 3), (False, 3), (True, 1)])
def test_i2vgen_forward_matches_jax(unet, with_image, frames):
    """The whole i2vgen UNet: fps embedding, first-frame concat stream (with
    the position maps when there is more than one frame), 64 local-image
    tokens, and the global tokens when an image embedding is given."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg, (jp, tp) = unet
    a = _inputs(cfg, frames, 7)
    if not with_image:
        a["image"] = None
    x, t = a.pop("x"), a.pop("t")
    got = tusv.forward(tp, tusv.UNetSDVideoConfig.tiny("i2vgen"), torch.from_numpy(x),
                       torch.from_numpy(t),
                       **{k: None if v is None else torch.from_numpy(v) for k, v in a.items()})
    want = jusv.forward(jp, cfg, jnp.asarray(x), jnp.asarray(t),
                        **{k: None if v is None else jnp.asarray(v) for k, v in a.items()})
    assert np.abs(np.asarray(want)).max() > 0.1  # a live net
    assert _rel(got, want) <= UNET_TOL


def test_i2vgen_image_streams_are_live(unet):
    """Both image inputs move the output: the global embedding (its tokens)
    and the first-frame latent (the concat stream and the local tokens)."""
    cfg, (_, tp) = unet
    tcfg = tusv.UNetSDVideoConfig.tiny("i2vgen")
    a = {k: torch.from_numpy(v) for k, v in _inputs(cfg, 3, 8).items()}
    base = tusv.forward(tp, tcfg, **a)
    for key in ("image", "local_image"):
        b = dict(a, **{key: a[key] + 1.0})
        assert (tusv.forward(tp, tcfg, **b) - base).abs().max() > 1e-3, key


def test_init_params_matches_the_jax_tree():
    """Same keys, shapes and zero leaves as the JAX init (i2vgen)."""
    import jax

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    jp = jax.tree.map(np.asarray, jusv.init_params(jax.random.PRNGKey(0),
                                                   jusv.UNetSDVideoConfig.tiny("i2vgen")))
    tp = _tree_map(lambda a: a.numpy(), tusv.init_params(
        torch.Generator().manual_seed(0), tusv.UNetSDVideoConfig.tiny("i2vgen"), "cpu"))
    assert jax.tree.structure(jp) == jax.tree.structure(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert bool(a.any()) == bool(b.any())
        if a.ndim >= 2 and a.any():  # the same init scale, 1 / sqrt(fan_in)
            assert 0.5 < a.std() / b.std() < 2.0
    for key in ("context_embed", "local_concat", "local_temporal", "local_embed", "fps_embed"):
        assert key in tp


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) on the same live tiny weights, with the
    same seeded stub image embedder."""
    import jax

    from vitron_tpu.models.diffusion import clip_text, unet_sd_video, vae, video_pipelines

    cfg = video_pipelines.Image2VideoConfig.tiny()
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    unet = _live(unet_sd_video.init_params(ks[0], cfg.unet), 40)
    vae_p = _live(vae.init_params(ks[1], cfg.vae), 41)
    text = _live(clip_text.init_params(ks[2], cfg.text), 42)
    tok = StubClipTokenizer(cfg.text.vocab_size)
    emb = StubImageEmbedder(cfg.unet.y_dim, seed=0)
    jpipe = video_pipelines.Image2VideoPipeline(cfg, unet[0], vae_p[0], text[0], tokenizer=tok,
                                                image_embedder=emb)
    tpipe = tvp.Image2VideoPipeline(tvp.Image2VideoConfig.tiny(), unet[1], vae_p[1], text[1],
                                    tokenizer=tok, image_embedder=emb)
    return jpipe, tpipe


def _jax_x_t(cfg):
    """The x_T that the JAX `run` draws from its default key PRNGKey(8800)."""
    import jax

    _, k = jax.random.split(jax.random.PRNGKey(8800))
    ls = cfg.latent_size
    return torch.from_numpy(np.array(jax.random.normal(
        k, (1, cfg.num_frames, ls, ls, cfg.unet.in_dim))))


def _image(h, w, seed=0):
    """A smooth uint8 test image (a gradient with noise), not flat."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([255 * yy / max(h - 1, 1), 255 * xx / max(w - 1, 1),
                     np.full((h, w), 128.0)], -1)
    return np.clip(base + rs.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def test_i2v_device_half_matches_jax(pipelines):
    """The port's `run` on the JAX run's own x_T: the VAE-encoded first
    frame, the DDIM latent and the decoded frames agree with the JAX
    pipeline's."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import clip_text as jct
    from vitron_tpu.models.diffusion import samplers as jsamp
    from vitron_tpu.models.diffusion import unet_sd_video as jusv
    from vitron_tpu.models.diffusion import vae as jvae
    from vitron_tpu.models.diffusion import video_pipelines as jvp

    jpipe, tpipe = pipelines
    cfg = jpipe.cfg
    img = _image(cfg.size, cfg.size)
    x_t = _jax_x_t(cfg)
    ids, pixels, glob = tpipe.prepare(img, PROMPT)
    assert torch.equal(pixels, torch.from_numpy(img))  # a cfg.size square image is kept as is
    # the first-frame latent and the sampled latent, through each package
    j_img = (jnp.asarray(img, jnp.float32) / 255.0 - 0.5) / 0.5
    j_local = jvae.encode(jpipe.vae_params, cfg.vae, j_img[None])[0] * jvae.SD_SCALE_FACTOR
    ctx2 = jct.encode(jpipe.text_params, cfg.text, jnp.asarray(ids.numpy()))
    j_glob = jnp.asarray(glob.numpy())

    def jv(x, t):
        out = jusv.forward(jpipe.unet_params, cfg.unet, jnp.concatenate([x, x]),
                           jnp.full((2,), t, jnp.float32), y=ctx2,
                           fps=jnp.full((2,), float(cfg.fps), jnp.float32),
                           image=jnp.concatenate([j_glob, jnp.zeros_like(j_glob)]),
                           local_image=jnp.concatenate([j_local, j_local]))
        v_c, v_uc = jnp.split(out, 2)
        return v_uc + cfg.guidance_scale * (v_c - v_uc)

    want_x = jsamp.ddim_sample_v(jv, jnp.asarray(x_t.numpy()), jvp._schedule(cfg.unet),
                                 cfg.steps)
    with torch.no_grad():
        local = tpipe.encode_image(pixels)
        v = tpipe.v_fn(tct.encode(tpipe.text_params, tpipe.cfg.text, ids), local, glob)
        got_x = tsamp.ddim_sample_v(v, x_t, tvp._schedule(tpipe.cfg.unet), cfg.steps)
        frames = tpipe.run(ids, pixels, glob, x_t, cfg.steps).numpy()
    assert _rel(local, j_local) <= MODULE_TOL * 10
    assert _rel(got_x, want_x) <= UNET_TOL
    want = np.asarray(jpipe.generate(jnp.asarray(img), PROMPT)).astype(np.int32)
    assert frames.shape == want.shape == (4, 16, 16, 3) and frames.dtype == np.uint8
    assert want.std() > 10  # not flat frames
    assert np.abs(frames.astype(np.int32) - want).max() <= 1


def test_route_g_matches_jax(pipelines, monkeypatch):
    """`VitronSystem.route` reaches the port's handle_g with the JAX system's
    status, task and video shape and type, hands `generate` the JAX
    handler's image and prompt, and answers a request without an image with
    the JAX system's error."""
    from vitron_tpu.runtime.router import route_model_output
    from vitron_tpu.runtime.system import VitronSystem as JSystem

    jpipe, tpipe = pipelines
    reply = "<module>G</module><instruction>the kite rises slowly</instruction>"
    img = _image(16, 16, seed=1)
    calls = {"jax": [], "port": []}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        def generate(image, *args, _orig=pipe.generate, _calls=calls[name], **kw):
            _calls.append((np.asarray(image), args, kw))
            return _orig(image, *args, **kw)

        monkeypatch.setattr(pipe, "generate", generate)
    jsys = JSystem(None)
    jsys.register_image2video(jpipe)
    tsys = VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=8 << 30))
    tsys.register_image2video(tpipe)
    want = route_model_output(jsys.registry, reply, image=img)
    with torch.no_grad():
        got = tsys.route(reply, image=img)
    for key in ("status", "task", "text"):
        assert got[key] == want[key], key
    assert got["status"] == "ok" and got["task"] == "image_to_video"
    assert got["video"].shape == np.asarray(want["video"]).shape == (4, 16, 16, 3)
    assert got["video"].dtype == np.uint8
    (ti, targs, tkw), = calls["port"]
    (ji, jargs, jkw), = calls["jax"]
    assert np.array_equal(ti, ji) and np.array_equal(ti, img)
    assert targs == jargs == ("the kite rises slowly",) and tkw == jkw == {}
    # the port's own x_T (a torch.Generator, seed 8800) gives frames, not noise
    assert got["video"].std() > 10
    no_image = route_model_output(jsys.registry, reply)
    got = tsys.route(reply)
    for key in ("status", "task", "text", "error"):
        assert got[key] == no_image[key], key
    assert got["status"] == "error" and "video" not in got


def test_non_square_image_is_resized_c7(pipelines):
    """C7: JAX's pipeline fails on an image that is not cfg.size square; the
    port resizes it on the host and gives the frames that JAX gives for the
    resized image (both without an image embedder, so the embedding does not
    see the two images' sizes)."""
    from vitron_tpu.models.diffusion import video_pipelines as jvp

    jpipe, tpipe = pipelines
    jp = jvp.Image2VideoPipeline(jpipe.cfg, jpipe.unet_params, jpipe.vae_params,
                                 jpipe.text_params, tokenizer=jpipe.tokenizer)
    tp = tvp.Image2VideoPipeline(tpipe.cfg, tpipe.unet_params, tpipe.vae_params,
                                 tpipe.text_params, tokenizer=tpipe.tokenizer)
    img = _image(16, 24, seed=2)
    import jax.numpy as jnp

    with pytest.raises(TypeError):
        jp.generate(jnp.asarray(img), PROMPT)
    with torch.no_grad():
        ids, pixels, glob = tp.prepare(img, PROMPT)
        assert pixels.shape == (16, 16, 3) and pixels.dtype == torch.uint8
        assert not bool(glob.any())  # no embedder: zeros, as in JAX (C4)
        frames = tp.run(ids, pixels, glob, _jax_x_t(jpipe.cfg), 4).numpy()
        own = tp.generate(img, PROMPT).numpy()
    want = np.asarray(jp.generate(jnp.asarray(pixels.numpy()), PROMPT)).astype(np.int32)
    assert own.shape == frames.shape == want.shape == (4, 16, 16, 3)
    assert np.abs(frames.astype(np.int32) - want).max() <= 1


@pytest.mark.parametrize("steps", [3, 7, 300, 1001])
@pytest.mark.parametrize("task", ["t2v", "i2v"])
def test_generate_refuses_a_step_count_not_dividing_1000_c6(pipelines, task, steps):
    """C6: DDIM-v over 1000 steps with a count that does not divide it
    starts at alpha 0 and gives NaN in the reference; both port pipelines
    raise before any work (the T2V one here has no UNet or VAE at all)."""
    _, tpipe = pipelines
    with pytest.raises(ValueError, match="divide"):
        if task == "t2v":
            tvp.Text2VideoPipeline(tvp.Text2VideoConfig.tiny(), None, None, tpipe.text_params,
                                   tokenizer=tpipe.tokenizer).generate(PROMPT, steps=steps)
        else:
            tpipe.generate(_image(16, 16), PROMPT, steps=steps)
