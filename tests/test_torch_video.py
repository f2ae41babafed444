"""Parity of the port's text-to-video slice (task D) with the JAX package on
the CPU: the zero-terminal-SNR schedule and v-prediction DDIM, the video
UNet's modules and forward at `UNetSDVideoConfig.tiny("t2v")` (with and
without the fps condition), the T2V pipeline's device half and `handle_d`
through `VitronSystem.route`.

The JAX params come from the JAX `init_params`, are carried across with
`from_jax`, and every all-zero leaf (each temporal conv block's conv3_w, each
res block's conv2_w, every proj_out_w, the out conv, fps_embed's last layer,
the biases) is filled by `synthetic.fill_zero_leaves`; the filled tree goes
back to JAX, so both packages hold the same live net: unfilled, the temporal
conv blocks are identities and the temporal transformers add nothing, and a
parity check would pass while testing nothing. Inputs are numpy arrays from
a seeded RandomState. Tolerances, max |port - JAX| / max |JAX|: 1e-5 for a
module in float32, 1e-3 for the whole UNet and the pipeline body in float32
(the order of float32 sums through ~20 layers), 2e-2 for a module in bf16
and 4e-2 for the whole bf16 UNet against JAX's float32 forward (measured,
`BF16_UNET_TOL`); frames agree to within 1 uint8 level.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion import clip_text as tct
from vitron_tpu_torch.models.diffusion import samplers as tsamp
from vitron_tpu_torch.models.diffusion import unet_sd_video as tusv
from vitron_tpu_torch.models.diffusion import video_pipelines as tvp
from vitron_tpu_torch.models.diffusion import video_unet as tvu
from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODULE_TOL, UNET_TOL, BF16_TOL = 1e-5, 1e-3, 2e-2


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


@pytest.fixture(scope="module")
def unets():
    """{fps condition: (config, (JAX params, port params))} at tiny("t2v")."""
    import jax

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    out = {}
    for i, fps in enumerate((False, True)):
        cfg = jusv.UNetSDVideoConfig.tiny("t2v", use_fps_condition=fps)
        out[fps] = (cfg, _live(jusv.init_params(jax.random.PRNGKey(i), cfg), 10 + i))
    return out


def _x(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


# ---------------------------------------------------------------- samplers

def test_zero_terminal_snr_schedule_and_ddim_arrays_are_bit_equal():
    from vitron_tpu.models.diffusion import samplers as jsamp

    for kw in (dict(schedule="cosine", zero_terminal_snr=True), dict(schedule="linear")):
        a, b = tsamp.DiffusionSchedule.create(**kw), jsamp.DiffusionSchedule.create(**kw)
        np.testing.assert_array_equal(a.betas, b.betas)
        np.testing.assert_array_equal(a.alphas_cumprod, b.alphas_cumprod)
        for got, want in zip(tsamp.make_ddim_arrays(a, 50, 0.5), jsamp.make_ddim_arrays(b, 50, 0.5)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsamp.rescale_zero_terminal_snr(np.linspace(1e-4, 0.02, 100)),
                                  jsamp.rescale_zero_terminal_snr(np.linspace(1e-4, 0.02, 100)))
    assert tsamp.DiffusionSchedule.create("cosine", zero_terminal_snr=True).alphas_cumprod[-1] == 0


@pytest.mark.parametrize("percentile", [None, 0.9])
def test_ddim_sample_v_matches_jax(percentile):
    """eta 0 with a fixed v-function of x and t; the percentile case clamps
    x0 (x_T scaled so the clamp bites)."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import samplers as jsamp

    rs = np.random.RandomState(0)
    x_t = _x(rs, 1, 3, 4, 5, 4, scale=4.0)
    mix = _x(rs, 4, 4, scale=0.3)

    def tv(x, t):
        return x @ torch.from_numpy(mix) + 0.1 * float(np.sin(t / 100.0))

    def jv(x, t):
        return x @ jnp.asarray(mix) + 0.1 * jnp.sin(jnp.asarray(t, jnp.float32) / 100.0)

    for kw in (dict(schedule="cosine", zero_terminal_snr=True), dict(schedule="linear")):
        s_t, s_j = tsamp.DiffusionSchedule.create(**kw), jsamp.DiffusionSchedule.create(**kw)
        got = tsamp.ddim_sample_v(tv, torch.from_numpy(x_t), s_t, 5, percentile=percentile)
        want = jsamp.ddim_sample_v(jv, jnp.asarray(x_t), s_j, 5, percentile=percentile)
        assert _rel(got, want) <= 1e-5


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_temporal_conv_block_matches_jax(unets, dtype):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import video_unet as jvu

    _, (jp, tp) = unets[False]
    jb = jp["input_blocks"][1][0]["tconv"]
    tb = tp["input_blocks"][1][0]["tconv"]
    x = _x(np.random.RandomState(1), 2, 4, 6, 5, 32)
    got = tvu.temporal_conv_block(tb, torch.from_numpy(x).to(getattr(torch, dtype)))
    want = jvu.temporal_conv_block(jb, jnp.asarray(x, getattr(jnp, dtype)))
    assert _rel(got, want) <= (MODULE_TOL if dtype == "float32" else BF16_TOL)
    # the filled conv3 makes the block more than its identity
    assert _rel(got, x) > 1e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_temporal_transformer_matches_jax(unets, dtype):
    """bf16: JAX rounds the frame-attention probabilities to bf16 and
    normalises after the product with v, the port's softmax is exact in
    float32 (as its kernel's)."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg, (jp, tp) = unets[False]
    e = jusv.block_plan(cfg)[0][0][1]  # the init block's ('tattn', dim, heads, inner)
    assert e[0] == "tattn"
    x = _x(np.random.RandomState(2), 2, 5, 4, 3, 32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = tusv.temporal_transformer(_tree_map(lambda a: a.to(td), tp["input_blocks"][0][1]),
                                    torch.from_numpy(x).to(td), e[2])
    want = jusv.temporal_transformer(_tree_map(lambda a: a.astype(jd), jp["input_blocks"][0][1]),
                                     jnp.asarray(x, jd), e[2])
    assert _rel(got, want) <= (MODULE_TOL if dtype == "float32" else BF16_TOL)
    assert _rel(got, x) > 1e-2


def test_spatial_transformer_linear_matches_jax(unets):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg, (jp, tp) = unets[False]
    blk = jusv.block_plan(cfg)[0][1]  # [('res', ...), ('sattn', ch, heads), ('tattn', ...)]
    assert blk[1][0] == "sattn"
    rs = np.random.RandomState(3)
    x, ctx = _x(rs, 6, 4, 3, 32), _x(rs, 6, 7, cfg.context_dim)
    got = tusv.spatial_transformer_linear(tp["input_blocks"][1][1], torch.from_numpy(x),
                                          torch.from_numpy(ctx), blk[1][2])
    want = jusv.spatial_transformer_linear(jp["input_blocks"][1][1], jnp.asarray(x),
                                           jnp.asarray(ctx), blk[1][2])
    assert _rel(got, want) <= MODULE_TOL


def test_res_block_matches_jax(unets):
    """A res block with a skip conv (32 -> 64) and its temporal conv block."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg, (jp, tp) = unets[False]
    blk = jusv.block_plan(cfg)[0][3]
    assert blk[0][:3] == ("res", 32, 64)
    rs = np.random.RandomState(4)
    x, emb = _x(rs, 2, 3, 4, 4, 32), _x(rs, 6, cfg.embed_dim)
    got = tusv._res_block(tp["input_blocks"][3][0], torch.from_numpy(x), torch.from_numpy(emb))
    want = jusv._res_block(jp["input_blocks"][3][0], jnp.asarray(x), jnp.asarray(emb))
    assert _rel(got, want) <= MODULE_TOL


def test_block_plan_matches_jax():
    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    for name in ("t2v", "tiny"):
        assert tusv.block_plan(getattr(tusv.UNetSDVideoConfig, name)()) == \
            jusv.block_plan(getattr(jusv.UNetSDVideoConfig, name)())


def _unet_inputs(cfg, seed):
    rs = np.random.RandomState(seed)
    return (_x(rs, 2, 3, 8, 8, cfg.in_dim), np.asarray([501.0, 17.0], np.float32),
            _x(rs, 2, 5, cfg.context_dim), np.asarray([8.0, 24.0], np.float32))


@pytest.mark.parametrize("fps", [False, True])
def test_unet_forward_matches_jax(unets, fps):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg, (jp, tp) = unets[fps]
    x, t, ctx, fr = _unet_inputs(cfg, 5)
    got = tusv.forward(tp, cfg, *(torch.from_numpy(a) for a in (x, t)),
                       y=torch.from_numpy(ctx), fps=torch.from_numpy(fr))
    want = jusv.forward(jp, cfg, jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(ctx),
                        fps=jnp.asarray(fr))
    assert np.abs(np.asarray(want)).max() > 0.1  # a live net
    assert _rel(got, want) <= UNET_TOL


# bf16 whole-UNet tolerance against JAX's float32 forward: measured 2.4e-2
# (fps off) and 2.0e-2 (fps on) on the two filled fixture nets. JAX's bf16
# forward rounds B7's probabilities and each B6 tap to bf16; the port keeps
# them in float32, so it is held to the float32 answer, not to JAX's bf16
BF16_UNET_TOL = 4e-2


@pytest.mark.parametrize("fps", [False, True])
def test_bf16_unet_matches_jax_float32(unets, fps):
    """The whole t2v UNet in bf16 (params, latents, context) against the JAX
    float32 forward: the port's bf16 arithmetic is held to the exact answer,
    not to JAX's bf16 rounding."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg, (jp, tp) = unets[fps]
    x, t, ctx, fr = _unet_inputs(cfg, 5)
    bf = torch.bfloat16
    got = tusv.forward(_tree_map(lambda a: a.to(bf) if a.is_floating_point() else a, tp), cfg,
                       torch.from_numpy(x).to(bf), torch.from_numpy(t),
                       y=torch.from_numpy(ctx).to(bf), fps=torch.from_numpy(fr))
    want = jusv.forward(jp, cfg, jnp.asarray(x), jnp.asarray(t), y=jnp.asarray(ctx),
                        fps=jnp.asarray(fr))
    assert got.dtype == bf
    assert _rel(got, want) <= BF16_UNET_TOL


def test_init_params_matches_the_jax_tree():
    """Same keys, shapes and zero leaves as the JAX init (t2v, with fps)."""
    import jax

    from vitron_tpu.models.diffusion import unet_sd_video as jusv

    cfg = jusv.UNetSDVideoConfig.tiny("t2v", use_fps_condition=True)
    jp = jax.tree.map(np.asarray, jusv.init_params(jax.random.PRNGKey(0), cfg))
    tp = _tree_map(lambda a: a.numpy(), tusv.init_params(torch.Generator().manual_seed(0),
                                                         tusv.UNetSDVideoConfig.tiny(
                                                             "t2v", use_fps_condition=True),
                                                         "cpu"))
    assert jax.tree.structure(jp) == jax.tree.structure(tp)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert bool(a.any()) == bool(b.any())
        if a.ndim >= 2 and a.any():  # the same init scale, 1 / sqrt(fan_in)
            assert 0.5 < a.std() / b.std() < 2.0


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) on the same live tiny weights."""
    import jax

    from vitron_tpu.models.diffusion import clip_text, unet_sd_video, vae, video_pipelines

    cfg = video_pipelines.Text2VideoConfig.tiny()
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    unet = _live(unet_sd_video.init_params(ks[0], cfg.unet), 20)
    vae_p = _live(vae.init_params(ks[1], cfg.vae), 21)
    text = _live(clip_text.init_params(ks[2], cfg.text), 22)
    tok = StubClipTokenizer(cfg.text.vocab_size)
    jpipe = video_pipelines.Text2VideoPipeline(cfg, unet[0], vae_p[0], text[0], tokenizer=tok)
    tpipe = tvp.Text2VideoPipeline(tvp.Text2VideoConfig.tiny(), unet[1], vae_p[1], text[1],
                                   tokenizer=tok)
    return jpipe, tpipe


def _jax_x_t(cfg):
    """The x_T that the JAX `run` draws from its default key PRNGKey(0)."""
    import jax

    _, k = jax.random.split(jax.random.PRNGKey(0))
    lh, lw = cfg.latent_hw
    return torch.from_numpy(np.array(jax.random.normal(
        k, (1, cfg.num_frames, lh, lw, cfg.unet.in_dim))))


def test_t2v_device_half_matches_jax(pipelines):
    """The port's `run` on the JAX run's own x_T: the DDIM latent and the
    decoded frames agree with the JAX pipeline's."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import clip_text as jct
    from vitron_tpu.models.diffusion import samplers as jsamp
    from vitron_tpu.models.diffusion import unet_sd_video as jusv
    from vitron_tpu.models.diffusion import video_pipelines as jvp

    jpipe, tpipe = pipelines
    cfg = jpipe.cfg
    x_t = _jax_x_t(cfg)
    ids = tpipe.tokenize(["a cat running on the beach", ""])
    # the latent after DDIM, through each package's UNet and sampler
    ctx2 = jct.encode(jpipe.text_params, cfg.text, jnp.asarray(ids.numpy()))

    def jv(x, t):
        out = jusv.forward(jpipe.unet_params, cfg.unet, jnp.concatenate([x, x]),
                           jnp.full((2,), t, jnp.float32), y=ctx2)
        v_c, v_uc = jnp.split(out, 2)
        return v_uc + cfg.guidance_scale * (v_c - v_uc)

    want_x = jsamp.ddim_sample_v(jv, jnp.asarray(x_t.numpy()), jvp._schedule(cfg.unet),
                                 cfg.steps)
    with torch.no_grad():
        got_x = tsamp.ddim_sample_v(tpipe.v_fn(tct.encode(tpipe.text_params, tpipe.cfg.text,
                                                          ids)),
                                    x_t, tvp._schedule(tpipe.cfg.unet), cfg.steps)
        frames = tpipe.run(ids, x_t, cfg.steps).numpy()
    assert _rel(got_x, want_x) <= UNET_TOL
    want = np.asarray(jpipe.generate("a cat running on the beach")).astype(np.int32)
    assert frames.shape == want.shape == (4, 16, 16, 3) and frames.dtype == np.uint8
    assert want.std() > 10  # not flat frames
    assert np.abs(frames.astype(np.int32) - want).max() <= 1


def test_route_d_matches_jax(pipelines, monkeypatch):
    """`VitronSystem.route` reaches the port's handle_d with the JAX system's
    status, task and video shape and type, and hands `generate` the JAX
    handler's prompt."""
    from vitron_tpu.runtime.router import route_model_output
    from vitron_tpu.runtime.system import VitronSystem as JSystem

    jpipe, tpipe = pipelines
    reply = "<module>D</module><instruction>a red car driving at night</instruction>"
    calls = {"jax": [], "port": []}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        def generate(*args, _orig=pipe.generate, _calls=calls[name], **kw):
            _calls.append((args, kw))
            return _orig(*args, **kw)

        monkeypatch.setattr(pipe, "generate", generate)
    jsys = JSystem(None)
    jsys.register_text2video(jpipe)
    want = route_model_output(jsys.registry, reply)
    tsys = VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=8 << 30))
    tsys.register_text2video(tpipe)
    with torch.no_grad():
        got = tsys.route(reply)
    for key in ("status", "task", "text"):
        assert got[key] == want[key], key
    assert got["status"] == "ok" and got["task"] == "video_generation"
    assert got["video"].shape == np.asarray(want["video"]).shape == (4, 16, 16, 3)
    assert got["video"].dtype == np.uint8
    assert calls["port"] == calls["jax"] == [(("a red car driving at night",), {})]
    # the port's own x_T (a torch.Generator, seed 0) gives frames, not noise
    assert got["video"].std() > 10
