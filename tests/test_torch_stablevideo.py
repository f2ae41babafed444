"""Parity of the port's task F (StableVideo editing) with the JAX package on
the CPU, at tiny configs: the ControlNet (`control_residuals`,
`controlled_forward` at `UNetConfig.tiny()`), the DPT-hybrid annotator
(`forward` and `depth_hint` at `DPTConfig.tiny()`), the atlas
pieces (`grid_sample_bilinear`, `render_frames`, `atlas_uvs`,
`imlp_forward`, `scatter_to_atlas`), the AGGNet refinement, the port's own
Canny against OpenCV's, `edit_image` from noise and from an image,
`advanced_edit_foreground` over 3 keyframes, `handle_f` through both
packages' `VitronSystem`, and the C12 guard (a size the UNet's skips cannot
meet: JAX fails inside the UNet, the port raises first).

The JAX params come from the JAX inits, are carried across with `from_jax`,
and every all-zero leaf (the ControlNet's zero convs, the UNet's zero
convs) is filled by `synthetic.fill_zero_leaves`; the filled tree goes back
to JAX, so both packages hold the same live nets. The edits take JAX's
noise (what its `rng` gives: `jax.random.split`, then `normal`) through the
port's explicit `noise=` argument. Tolerances: max |port - JAX| / max |JAX|
of 1e-5 for a module in float32 and 1e-4 for a whole ControlNet or UNet
call (float32 sums in other orders through ~10 layers); uint8 outputs within
2 levels on at least 99% of pixels (`_close_u8`); griddata and Canny
exactly.
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion import clip_text as tct
from vitron_tpu_torch.models.diffusion import controlnet as tcn
from vitron_tpu_torch.models.diffusion import depth as tdp
from vitron_tpu_torch.models.diffusion import stablevideo as tsv
from vitron_tpu_torch.models.diffusion import unet2d as tun
from vitron_tpu_torch.models.diffusion import vae as tvae
from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODULE_TOL, NET_TOL = 1e-5, 1e-4
U8_LEVELS, U8_SHARE = 2, 0.99
STEPS = 5
FORE, BACK = "a red kite", "a snowy field"


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


def _close_u8(got, want, what=""):
    got = (got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)).astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    share = float((np.abs(got - want) <= U8_LEVELS).mean())
    assert share >= U8_SHARE, (what, share)
    return share


@pytest.fixture(scope="module")
def nets():
    """Live tiny nets on both sides: {"unet", "canny", "depth_ctrl", "vae",
    "text", "dpt"} -> (JAX tree, port tree), and the configs."""
    import jax

    from vitron_tpu.models.diffusion import clip_text as jct
    from vitron_tpu.models.diffusion import controlnet as jcn
    from vitron_tpu.models.diffusion import depth as jdp
    from vitron_tpu.models.diffusion import unet2d as jun
    from vitron_tpu.models.diffusion import vae as jvae

    k = jax.random.PRNGKey
    ucfg = jun.UNetConfig.tiny()
    tcfg = jct.TextConfig.tiny(hidden_size=16, num_heads=2, intermediate_size=32)
    out = {
        "unet": _live(jun.init_params(k(0), ucfg, grounding=False), 1),
        "canny": _live(jcn.init_params(k(1), ucfg), 2),
        "depth_ctrl": _live(jcn.init_params(k(5), ucfg), 3),
        "vae": _live(jvae.init_params(k(2), jvae.VAEConfig.tiny()), 4),
        "text": _live(jct.init_params(k(3), tcfg), 5),
        "dpt": _live(jdp.init_params(k(6), jdp.DPTConfig.tiny()), 6),
    }
    cfgs = {"unet": (ucfg, tun.UNetConfig.tiny()),
            "vae": (jvae.VAEConfig.tiny(), tvae.VAEConfig.tiny()),
            "text": (tcfg, tct.TextConfig.tiny(hidden_size=16, num_heads=2,
                                               intermediate_size=32)),
            "dpt": (jdp.DPTConfig.tiny(), tdp.DPTConfig.tiny())}
    return out, cfgs


def _editors(nets, depth=False):
    from vitron_tpu.models.diffusion import stablevideo as jsv

    n, c = nets
    tok = StubClipTokenizer(c["text"][0].vocab_size)
    args = {}
    for side, i in (("jax", 0), ("port", 1)):
        kw = {}
        if depth:
            kw = dict(depth_control_params=n["depth_ctrl"][i],
                      depth_annotator=(n["dpt"][i], c["dpt"][i]))
        cls = jsv.StableVideoEditor if side == "jax" else tsv.StableVideoEditor
        args[side] = cls(c["unet"][i], n["unet"][i], n["canny"][i], c["vae"][i], n["vae"][i],
                         c["text"][i], n["text"][i], tokenizer=tok, **kw)
    return args["jax"], args["port"]


def _jax_edit_noise(key, shape):
    """The noise JAX's edit_image draws from `key` (stablevideo.py:329-338)."""
    import jax

    _, k = jax.random.split(key)
    return torch.from_numpy(np.array(jax.random.normal(k, shape)))


# ----------------------------------------------------------------- ControlNet

def test_controlnet_matches_jax(nets):
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import controlnet as jcn

    n, c = nets
    ucfg, tcfg = c["unet"]
    residuals = jax.jit(jcn.control_residuals, static_argnums=1)
    forward = jax.jit(jcn.controlled_forward, static_argnums=(1, 6))
    rs = np.random.RandomState(0)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    hint = rs.rand(2, 64, 64, 3).astype(np.float32)
    ctx = rs.randn(2, 7, 16).astype(np.float32)
    t = np.asarray([500, 20])
    want = residuals(n["canny"][0], ucfg, jnp.asarray(x), jnp.asarray(hint), jnp.asarray(t),
                     jnp.asarray(ctx))
    got = tcn.control_residuals(n["canny"][1], tcfg, torch.from_numpy(x), torch.from_numpy(hint),
                                torch.from_numpy(t), torch.from_numpy(ctx))
    assert len(got) == len(want) == len(tun.block_plan(tcfg)[0]) + 1
    for g, w in zip(got, want):
        assert _rel(g, w) < NET_TOL
    feats = tcn.hint_features(n["canny"][1], torch.from_numpy(hint))
    assert _rel(feats, jcn.hint_features(n["canny"][0], jnp.asarray(hint))) < MODULE_TOL
    out_w = forward(n["unet"][0], ucfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx), want,
                    0.7)
    out_g = tcn.controlled_forward(n["unet"][1], tcfg, torch.from_numpy(x), torch.from_numpy(t),
                                   torch.from_numpy(ctx), got, control_scale=0.7)
    assert _rel(out_g, out_w) < NET_TOL
    # the port's own init: the JAX tree's keys and shapes
    own = tcn.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    shapes = _tree_map(lambda a: tuple(a.shape), own)
    assert shapes == _tree_map(lambda a: tuple(a.shape), n["canny"][1])


# ----------------------------------------------------------------- DPT

@pytest.fixture
def jit_dpt(monkeypatch):
    """JAX's DPT forward jitted (depth_hint calls it through the module)."""
    import jax

    from vitron_tpu.models.diffusion import depth as jdp

    monkeypatch.setattr(jdp, "forward", jax.jit(jdp.forward, static_argnums=1))
    return jdp


def test_dpt_forward_matches_jax(nets, jit_dpt):
    """DPT-hybrid's forward at two sizes, and the port's own init: the JAX
    tree's keys and shapes."""
    import jax.numpy as jnp

    jdp = jit_dpt
    (jp, tp), (jcfg, tcfg) = nets[0]["dpt"], nets[1]["dpt"]
    rs = np.random.RandomState(1)
    for hw in ((64, 64), (64, 96)):
        img = (rs.rand(1, *hw, 3) * 2 - 1).astype(np.float32)
        want = jdp.forward(jp, jcfg, jnp.asarray(img))
        got = tdp.forward(tp, tcfg, torch.from_numpy(img))
        assert _rel(got, want) < NET_TOL, hw
    own = tdp.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert _tree_map(lambda a: tuple(a.shape), own) == _tree_map(lambda a: tuple(a.shape), tp)
    with pytest.raises(ValueError, match="not ported"):
        tdp.forward(tp, tdp.DPTConfig.tiny(variant="dpt_large"), torch.from_numpy(img))


def test_depth_hint_matches_jax(nets, jit_dpt):
    jdp = jit_dpt
    n, c = nets
    rs = np.random.RandomState(2)
    for hw in ((40, 48), (64, 64)):  # resized to the 32-pixel stride and back, and not
        img = rs.randint(0, 256, hw + (3,), np.uint8)
        want = jdp.depth_hint(n["dpt"][0], c["dpt"][0], img)
        got = tdp.depth_hint(n["dpt"][1], c["dpt"][1], img)
        assert got.shape == want.shape == hw + (3,)
        assert np.abs(got - want).max() < 1e-4, hw


# ----------------------------------------------------------------- atlas pieces

def _imlp_cfgs(side):
    mod = tsv
    if side == "jax":
        from vitron_tpu.models.diffusion import stablevideo as mod
    c = mod.IMLPConfig(hidden_dim=16, num_layers=4, positional_dim=4, skip_layers=(2,))
    a = mod.IMLPConfig(hidden_dim=16, num_layers=4, positional_dim=4, skip_layers=(2,),
                       output_dim=1)
    return {"fg": c, "bg": c, "alpha": a}


@pytest.fixture(scope="module")
def imlps():
    """(JAX, port) fg / bg / alpha IMLP params."""
    import jax

    from vitron_tpu.models.diffusion import stablevideo as jsv

    cfg = _imlp_cfgs("jax")
    j = {name: jsv.imlp_init(jax.random.PRNGKey(i), cfg[name])
         for i, name in enumerate(("fg", "bg", "alpha"))}
    return j, {name: from_jax(jax.tree.map(np.asarray, p), "cpu") for name, p in j.items()}


def test_atlas_pieces_match_jax(imlps):
    """imlp_forward, atlas_uvs (with scales and max_frames),
    grid_sample_bilinear (corners clamped) and render_frames."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import stablevideo as jsv

    j, t = imlps
    jc, tc = _imlp_cfgs("jax"), _imlp_cfgs("port")
    rs = np.random.RandomState(3)
    pts = (rs.rand(37, 3) * 2 - 1).astype(np.float32)
    for use_tanh in (True, False):
        want = jsv.imlp_forward(j["fg"], jc["fg"], jnp.asarray(pts), use_tanh=use_tanh)
        assert _rel(tsv.imlp_forward(t["fg"], tc["fg"], torch.from_numpy(pts),
                                     use_tanh=use_tanh), want) < MODULE_TOL
    want = jsv.atlas_uvs(j["fg"], j["bg"], j["alpha"], jc, 3, 8, 12, fg_uv_scale=0.8,
                         bg_uv_scale=0.9, max_frames=5)
    got = tsv.atlas_uvs(t["fg"], t["bg"], t["alpha"], tc, 3, 8, 12, fg_uv_scale=0.8,
                        bg_uv_scale=0.9, max_frames=5)
    for g, w in zip(got, want):
        assert _rel(g, w) < MODULE_TOL
    img = rs.randn(9, 11, 3).astype(np.float32)
    uv = (rs.rand(4, 5, 2) * 2.4 - 1.2).astype(np.float32)  # past the corners too
    assert _rel(tsv.grid_sample_bilinear(torch.from_numpy(img), torch.from_numpy(uv)),
                jsv.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(uv))) < MODULE_TOL
    fg, bg = rs.rand(16, 16, 3).astype(np.float32), rs.rand(16, 16, 3).astype(np.float32)
    fuv, buv = (rs.rand(2, 2, 8, 8, 2) * 2 - 1).astype(np.float32)
    alpha = rs.rand(2, 8, 8, 1).astype(np.float32)
    want = jsv.render_frames(*(jnp.asarray(a) for a in (fg, bg, fuv, buv, alpha)))
    got = tsv.render_frames(*(torch.from_numpy(a) for a in (fg, bg, fuv, buv, alpha)))
    assert _rel(got, want) < MODULE_TOL


def test_scatter_to_atlas_matches_jax():
    """Both call scipy's griddata on the same points: exactly equal."""
    from vitron_tpu.models.diffusion import stablevideo as jsv

    rs = np.random.RandomState(4)
    frame = rs.rand(12, 14, 3).astype(np.float32)
    uv = np.clip(np.stack(np.meshgrid(np.linspace(-0.9, 0.8, 14), np.linspace(-1, 0.7, 12)),
                          -1) + rs.randn(12, 14, 2) * 0.02, -1, 1).astype(np.float32)
    want = jsv.scatter_to_atlas(frame, uv, (10, 9))
    got = tsv.scatter_to_atlas(frame, uv, (10, 9))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].any() and not got[1].all()


def test_aggnet_refine_matches_jax():
    """5 steps of SGD with momentum 0.9 from the same init (the JAX init's
    PRNGKey(0)), then the refined atlas; and the forward alone."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import stablevideo as jsv

    rs = np.random.RandomState(5)
    agg = rs.rand(16, 16, 3).astype(np.float32)
    frames = [rs.rand(8, 8, 3).astype(np.float32) for _ in range(2)]
    uvs = [(rs.rand(8, 8, 2) * 2 - 1).astype(np.float32) for _ in range(2)]
    init = jsv.aggnet_init(jax.random.PRNGKey(0))
    tinit = from_jax(jax.tree.map(np.asarray, init), "cpu")
    assert _rel(tsv.aggnet_forward(tinit, torch.from_numpy(agg)[None]),
                jsv.aggnet_forward(init, jnp.asarray(agg)[None])) < MODULE_TOL
    want = jsv._aggnet_refine(jnp.asarray(agg), [jnp.asarray(f) for f in frames],
                              [jnp.asarray(u) for u in uvs], epochs=5, lr=0.05)
    got = tsv._aggnet_refine(torch.from_numpy(agg), [torch.from_numpy(f) for f in frames],
                             [torch.from_numpy(u) for u in uvs], epochs=5, lr=0.05,
                             params=tinit)
    assert _rel(got, want) < NET_TOL
    assert _rel(got, tsv.aggnet_forward(tinit, torch.from_numpy(agg)[None])[0]) > 1e-3


def _canny_images():
    rs = np.random.RandomState(6)
    y, x = np.mgrid[0:96, 0:128]
    edges = np.stack([((x - 60) ** 2 + (y - 40) ** 2 < 900) * 200, (x > 70) * 150,
                      ((x + y) % 40 < 20) * 120], -1).astype(np.uint8)
    grad = np.broadcast_to(((x * 3 + y) % 256).astype(np.uint8)[..., None], (96, 128, 3))
    noise = rs.randint(0, 256, (48, 64, 3), np.uint8)
    # noise smoothed by a 5x5 box: gradients of every size and direction
    pad = np.pad(rs.randint(0, 256, (104, 136, 3)).astype(np.float32), ((2, 2), (2, 2), (0, 0)))
    smooth = sum(pad[i:i + 104, j:j + 136] for i in range(5) for j in range(5)) / 25
    return {"random": noise, "gradient": np.ascontiguousarray(grad), "edges": edges,
            "smooth": smooth.astype(np.uint8), "gray": noise[..., 0].copy()}


@pytest.mark.parametrize("name", sorted(_canny_images()))
def test_canny_matches_opencv(name):
    """The port's Canny equals cv2.Canny(image, 100, 200) pixel for pixel
    (and at other thresholds on the smooth image)."""
    import cv2

    img = _canny_images()[name]
    for low, high in ((100, 200),) + (((20, 60), (50, 51)) if name == "smooth" else ()):
        want = cv2.Canny(img, low, high)
        np.testing.assert_array_equal(tsv.canny(img, low, high), want)
        if low == 100:
            assert (want > 0).any() or name == "gradient"
    hint = tsv.canny_hint(img if img.ndim == 3 else np.stack([img] * 3, -1))
    assert hint.dtype == np.float32 and hint.shape[-1] == 3


# ----------------------------------------------------------------- editing

@pytest.mark.parametrize("from_noise", [True, False])
def test_edit_image_matches_jax(nets, from_noise):
    import jax
    import jax.numpy as jnp

    jed, ted = _editors(nets)
    rs = np.random.RandomState(7)
    img = rs.randint(0, 256, (32, 32, 3), np.uint8)
    hint = tsv.canny_hint(img)
    key = jax.random.PRNGKey(4)
    want = jed.edit_image(jnp.asarray(img), jnp.asarray(hint), FORE, "blurry", strength=0.8,
                          steps=STEPS, rng=key, from_noise=from_noise)
    got = ted.edit_image(img, hint, FORE, "blurry", strength=0.8, steps=STEPS,
                         noise=_jax_edit_noise(key, (1, 16, 16, 4)), from_noise=from_noise)
    assert got.dtype == torch.uint8 and got.shape == (32, 32, 3)
    _close_u8(got, want)
    assert int(got.max()) - int(got.min()) > 16  # not constant


def _uv_field(rs, h, w):
    gy, gx = np.meshgrid(np.linspace(-0.8, 0.8, h), np.linspace(-0.8, 0.8, w), indexing="ij")
    return np.clip(np.stack([gx, gy], -1) * rs.uniform(0.8, 1.1) + rs.randn(2) * 0.05
                   + rs.randn(h, w, 2) * 0.01, -1, 1).astype(np.float32)


def test_advanced_edit_foreground_matches_jax(nets):
    """Three keyframes (the first from noise, the others propagated
    through the atlas), scattered and median-aggregated: the atlas within
    2/255 on 99% of its values."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import stablevideo as jsv

    jed, ted = _editors(nets)
    rs = np.random.RandomState(8)
    kfs = [rs.randint(0, 256, (32, 32, 3), np.uint8) for _ in range(3)]
    uvs = [_uv_field(rs, 32, 32) for _ in range(3)]
    alphas = [rs.uniform(0.5, 1.0, (32, 32, 1)).astype(np.float32) for _ in range(3)]
    rng, noises = jax.random.PRNGKey(0), []
    for _ in range(3):  # advanced_edit_foreground's keys, then edit_image's
        rng, k = jax.random.split(rng)
        noises.append(_jax_edit_noise(k, (1, 16, 16, 4)))
    want = jsv.advanced_edit_foreground(jed, kfs, uvs, alphas, (24, 24), FORE, steps=STEPS)
    got = tsv.advanced_edit_foreground(ted, kfs, uvs, alphas, (24, 24), FORE, steps=STEPS,
                                       noises=noises)
    assert got.shape == (24, 24, 3) and got.dtype == np.float32
    _close_u8(np.round(got * 255), np.round(np.asarray(want) * 255))
    assert got.max() > 0.1


def _atlas_bundle(imlps, frames=4, h=32, w=32):
    """A synthetic atlas bundle: random 32x32 atlases and the UVs and alpha
    of random IMLP nets (numpy)."""
    rs = np.random.RandomState(9)
    j, t = imlps
    fg_uv, bg_uv, alpha = (a.numpy() for a in tsv.atlas_uvs(t["fg"], t["bg"], t["alpha"],
                                                            _imlp_cfgs("port"), frames, h, w))
    return {"fg_atlas": rs.rand(32, 32, 3).astype(np.float32),
            "bg_atlas": rs.rand(32, 32, 3).astype(np.float32),
            "fg_uv": fg_uv, "bg_uv": bg_uv, "alpha": alpha}


def test_route_f_matches_jax(nets, imlps, jit_dpt):
    """A task-F reply routed through both packages' VitronSystem on the same
    atlas bundle (the background through the depth ControlNet and DPT):
    status, task, frames' shape and type, frames within 2 levels on 99%;
    no atlas provider gives JAX's error."""
    import jax

    from vitron_tpu.runtime.router import route_model_output
    from vitron_tpu.runtime.system import VitronSystem as JSystem

    jed, ted = _editors(nets, depth=True)
    bundle = _atlas_bundle(imlps)
    reply = f"<module>F</module><instruction>{FORE}</instruction><instruction>{BACK}</instruction>"
    video = np.zeros((4, 32, 32, 3), np.uint8)
    keys, rng = {}, jax.random.PRNGKey(0)
    for i in range(3):
        rng, k = jax.random.split(rng)
        keys[i] = k
    keys["back"] = jax.random.PRNGKey(0)
    jsys = JSystem(None)
    jsys.register_video_editor(jed, atlas_provider=lambda v, e: bundle)
    tsys = VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=8 << 30))
    tsys.register_video_editor(ted, atlas_provider=lambda v, e: bundle,
                               noise_source=lambda key: _jax_edit_noise(keys[key],
                                                                        (1, 16, 16, 4)))
    want = route_model_output(jsys.registry, reply, video=video)
    with torch.no_grad():
        got = tsys.route(reply, video=video)
    for key in ("status", "task"):
        assert got[key] == want[key], key
    assert got["video"].dtype == np.uint8 and got["video"].shape == (4, 32, 32, 3)
    _close_u8(got["video"], want["video"])
    bare_j, bare_t = JSystem(None), VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=1))
    bare_j.register_video_editor(jed)
    bare_t.register_video_editor(ted)
    want = route_model_output(bare_j.registry, reply, video=video)
    got = bare_t.route(reply, video=video)
    assert (got["status"], got.get("error")) == (want["status"], want.get("error"))


def test_c12_sizes_raise(nets):
    """A side that is not a multiple of the VAE factor x 2^(levels - 1)
    breaks the UNet's skip concat: JAX fails inside the UNet, the port
    raises a ValueError naming C12 before any device work. SD's multiple is
    64: LNA's 432x768 frames are refused, 448x768 taken."""
    import jax.numpy as jnp

    jed, ted = _editors(nets)
    img = np.random.RandomState(10).randint(0, 256, (30, 32, 3), np.uint8)
    hint = tsv.canny_hint(img)
    with pytest.raises(Exception):
        jed.edit_image(jnp.asarray(img), jnp.asarray(hint), FORE, steps=2, from_noise=True)
    assert ted.size_multiple == 4
    with pytest.raises(ValueError, match="C12"):
        ted.edit_image(img, hint, FORE, steps=2, from_noise=True)
    sd = tsv.StableVideoEditor(tun.UNetConfig.sd_v1(), {"time_w1": torch.zeros(1)}, None,
                               tvae.VAEConfig.sd(), None, None, None)
    assert sd.size_multiple == 64
    with pytest.raises(ValueError, match="C12"):
        sd.check_size(432, 768)
    sd.check_size(448, 768)
