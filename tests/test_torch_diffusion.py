"""Parity of the port's GLIGEN slice (tasks A/C) with the JAX package on the
CPU: layers, CLIP text, VAE, UNet (4 and 9 input channels, with and without
grounding), PLMS, the generate body and the A/C routes.

Tiny configs. The JAX params are made by the JAX `init_params`, carried
across with `from_jax`, and every all-zero leaf (ResNet conv2, proj_out, the
UNet's out conv, the GLIGEN gates, the biases) is filled by
`synthetic.fill_zero_leaves`; the filled tree goes back to JAX, so both
packages hold the same live net and no check passes on a zero output.
Inputs are numpy arrays from a seeded RandomState. Float32 tolerances are
stated per test; images must agree to within 1 uint8 level.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion import clip_text as tct
from vitron_tpu_torch.models.diffusion import gligen_pipeline as tgp
from vitron_tpu_torch.models.diffusion import layers as tl
from vitron_tpu_torch.models.diffusion import samplers as tsamp
from vitron_tpu_torch.models.diffusion import unet2d as tunet
from vitron_tpu_torch.models.diffusion import vae as tvae
from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = ATOL = 1e-4


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _live(jax_params, seed):
    """(numpy tree for JAX, torch tree for the port) of one live net."""
    import jax

    t = fill_zero_leaves(from_jax(jax.tree.map(np.asarray, jax_params), "cpu"),
                         torch.Generator().manual_seed(seed))
    return _tree_map(lambda a: a.numpy(), t), t


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def nets():
    """The tiny GLIGEN config and live (JAX numpy, port torch) param pairs."""
    import jax

    from vitron_tpu.models.diffusion import clip_text, gligen_pipeline, unet2d, vae

    cfg = gligen_pipeline.GligenConfig.tiny()
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    u9 = dataclasses.replace(cfg.unet, in_channels=9)
    nets = {
        "cfg": cfg,
        "unet": _live(unet2d.init_params(ks[0], cfg.unet), 1),
        "unet9": _live(unet2d.init_params(ks[1], u9), 2),
        "vae": _live(vae.init_params(ks[2], cfg.vae), 3),
        "text": _live(clip_text.init_params(ks[3], cfg.text), 4),
    }
    # plain SD: the grounded net without its fusers and position net
    nets["unet_plain"] = tuple(_drop_grounding(t) for t in nets["unet"])
    return nets


def _drop_grounding(tree):
    if isinstance(tree, dict):
        return {k: _drop_grounding(v) for k, v in tree.items()
                if k not in ("fuser", "position_net")}
    if isinstance(tree, list):
        return [_drop_grounding(v) for v in tree]
    return tree


def test_from_jax_carries_the_gligen_tree():
    """`from_jax` keeps the UNet's block lists and its scalar GLIGEN gates
    (0-d leaves) as they are, key for key."""
    import jax

    from vitron_tpu.models.diffusion import gligen_pipeline, unet2d

    jp = jax.tree.map(np.asarray, unet2d.init_params(
        jax.random.PRNGKey(5), gligen_pipeline.GligenConfig.tiny().unet))
    tp = from_jax(jp, "cpu")
    back = _tree_map(lambda a: a.numpy(), tp)
    assert jax.tree.structure(jp) == jax.tree.structure(back)
    for want, got in zip(jax.tree.leaves(jp), jax.tree.leaves(back)):
        np.testing.assert_array_equal(got, want)
    fuser = tp["input_blocks"][1][1]["blocks"][0]["fuser"]
    for gate in ("alpha_attn", "alpha_dense"):
        assert fuser[gate].dim() == 0 and fuser[gate].dtype == torch.float32


def test_group_norm_matches_jax():
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import layers as jl

    rs = np.random.RandomState(0)
    x = (rs.randn(2, 6, 5, 64) * 3 + 1).astype(np.float32)
    s, b = rs.randn(64).astype(np.float32), rs.randn(64).astype(np.float32)
    want = jl.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    _close(tl.group_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_einsum_matches_jax(dtype):
    """Both einsum branches: exact float32 softmax, and bf16 probabilities
    normalised after attn @ v (bf16 tolerance: 2e-2 on unit-scale values)."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import layers as jl

    rs = np.random.RandomState(1)
    q, k, v = (rs.randn(2, n, 4 * 8).astype(np.float32) for n in (12, 20, 20))
    want = np.asarray(jl._mha(*(jnp.asarray(a, dtype) for a in (q, k, v)), 4, 8 ** -0.5),
                      np.float32)
    tdt = getattr(torch, dtype)
    got = tl._mha(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), 4, 8 ** -0.5)
    tol = RTOL if dtype == "float32" else 2e-2
    _close(got.float(), want, tol, tol)


def test_transformer_block_matches_jax(nets):
    """The first input-level transformer block with its GLIGEN fuser live
    (gate 0.7), cross-attending a 7-token context."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import layers as jl

    jp, tp = nets["unet"]
    blk_j, blk_t = jp["input_blocks"][1][1]["blocks"][0], tp["input_blocks"][1][1]["blocks"][0]
    rs = np.random.RandomState(2)
    x = rs.randn(2, 24, 32).astype(np.float32)
    ctx = rs.randn(2, 7, 16).astype(np.float32)
    objs = rs.randn(2, 4, 16).astype(np.float32)
    want = jax.jit(lambda *a: jl.basic_transformer_block(*a, 2, 0.7))(
        blk_j, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(objs))
    got = tl.basic_transformer_block(blk_t, torch.from_numpy(x), torch.from_numpy(ctx),
                                     torch.from_numpy(objs), 2, 0.7)
    _close(got, want)
    # the fuser is live: switching its gate off moves the output
    off = tl.basic_transformer_block(blk_t, torch.from_numpy(x), torch.from_numpy(ctx),
                                     torch.from_numpy(objs), 2, 0.0)
    assert (off - got).abs().max().item() > 1e-2


def test_position_net_matches_jax(nets):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import layers as jl

    jp, tp = nets["unet"]
    rs = np.random.RandomState(3)
    boxes = rs.rand(2, 4, 4).astype(np.float32)
    masks = np.asarray([[1, 1, 0, 0], [1, 0, 1, 0]], np.float32)
    text = rs.randn(2, 4, 16).astype(np.float32)
    want = jl.position_net(jp["position_net"], jnp.asarray(boxes), jnp.asarray(masks),
                           jnp.asarray(text))
    got = tl.position_net(tp["position_net"], torch.from_numpy(boxes),
                          torch.from_numpy(masks), torch.from_numpy(text))
    _close(got, want)


def test_clip_text_encode_matches_jax(nets):
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import clip_text as jct

    jp, tp = nets["text"]
    cfg = nets["cfg"].text
    ids = np.random.RandomState(4).randint(0, cfg.vocab_size, (3, cfg.max_length))
    for skip in (0, 1):
        want = jct.encode(jp, cfg, jnp.asarray(ids), skip_last=skip)
        got = tct.encode(tp, tct.TextConfig(**dataclasses.asdict(cfg)), torch.from_numpy(ids),
                         skip_last=skip)
        _close(got, want)


def test_vae_matches_jax(nets):
    """Encode (with its padded stride-2 downsample) and decode."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import vae as jvae

    jp, tp = nets["vae"]
    rs = np.random.RandomState(5)
    img = rs.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    z = rs.randn(2, 16, 16, 4).astype(np.float32)
    jm, jlv = jax.jit(lambda p, x: jvae.encode(p, nets["cfg"].vae, x))(jp, jnp.asarray(img))
    tm, tlv = tvae.encode(tp, tvae.VAEConfig.tiny(), torch.from_numpy(img))
    _close(tm, jm)
    _close(tlv, jlv)
    want = jax.jit(lambda p, x: jvae.decode(p, nets["cfg"].vae, x))(jp, jnp.asarray(z))
    _close(tvae.decode(tp, tvae.VAEConfig.tiny(), torch.from_numpy(z)), want)


@pytest.mark.parametrize("which", ["grounded", "inpaint9", "no_fuser"])
def test_unet_forward_matches_jax(nets, which):
    """Float32 UNet forward; atol is 1e-4 of max |eps| (the live random net's
    output reaches ~10, where float32 rounding of two summation orders alone
    is ~1e-5 relative)."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import unet2d as junet

    key = {"grounded": "unet", "inpaint9": "unet9", "no_fuser": "unet_plain"}[which]
    jp, tp = nets[key]
    cin = 9 if which == "inpaint9" else 4
    jcfg = dataclasses.replace(nets["cfg"].unet, in_channels=cin)
    tcfg = tunet.UNetConfig.tiny(in_channels=cin)
    rs = np.random.RandomState(6)
    x = rs.randn(2, 8, 8, cin).astype(np.float32)
    t = np.asarray([981, 21], np.int32)
    ctx = rs.randn(2, 16, 16).astype(np.float32)
    objs = None if which == "no_fuser" else rs.randn(2, 4, 16).astype(np.float32)
    fwd = jax.jit(lambda p, *a: junet.forward(p, jcfg, *a, gate_scale=0.6))
    want = np.asarray(fwd(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                          None if objs is None else jnp.asarray(objs)))
    got = tunet.forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(t).long(),
                        torch.from_numpy(ctx), None if objs is None else torch.from_numpy(objs),
                        gate_scale=0.6)
    assert np.abs(want).max() > 1.0  # a live net, not the zero-init output
    _close(got, want, RTOL, 1e-4 * np.abs(want).max())


def _mock_eps(x, t, gate):
    """A stand-in for the UNet that both packages' array types accept."""
    return 0.1 * x + 1e-3 * t + 0.05 * gate


@pytest.mark.parametrize("blend", [False, True])
def test_plms_sample_matches_jax(blend):
    """10 PLMS steps (Heun, then AB2/3/4) with the alpha schedule; the blend
    case hands the port the noise the JAX sampler draws from its keys."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import samplers as js

    rs = np.random.RandomState(7)
    x = rs.randn(1, 6, 6, 4).astype(np.float32)
    steps = 10
    gates = js.alpha_generator(steps, (0.3, 0.2, 0.5))
    np.testing.assert_array_equal(tsamp.alpha_generator(steps, (0.3, 0.2, 0.5)), gates)
    sched_j = js.DiffusionSchedule.create("linear", 1000, 0.00085, 0.012)
    sched_t = tsamp.DiffusionSchedule.create("linear", 1000, 0.00085, 0.012)
    rng = jax.random.PRNGKey(3)
    mb_j = mb_t = None
    if blend:
        keep = (rs.rand(1, 6, 6, 1) > 0.5).astype(np.float32)
        x0 = rs.randn(1, 6, 6, 4).astype(np.float32)
        noise = np.stack([np.asarray(jax.random.normal(jax.random.split(k)[0], x0.shape))
                          for k in jax.random.split(rng, steps)])
        mb_j = (jnp.asarray(keep), jnp.asarray(x0))
        mb_t = (torch.from_numpy(keep), torch.from_numpy(x0), torch.from_numpy(noise))
    want = js.plms_sample(_mock_eps, jnp.asarray(x), sched_j, steps, rng=rng,
                          gate_alphas=gates, mask_blend=mb_j)
    got = tsamp.plms_sample(_mock_eps, torch.from_numpy(x), sched_t, steps,
                            gate_alphas=gates, mask_blend=mb_t)
    _close(got, want)


# ---------------------------------------------------------------- A/C routes


def _pipelines(nets):
    """(JAX pipeline, port pipeline) on the same live weights and tokens."""
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import gligen_pipeline as jgp

    cfg = nets["cfg"]
    tok = StubClipTokenizer(cfg.text.vocab_size)

    def j(name):
        return _tree_map(jnp.asarray, nets[name][0])

    jpipe = jgp.GligenPipeline(cfg, j("unet"), j("vae"), j("text"),
                               inpaint_unet_params=j("unet9"), tokenizer=tok)
    tpipe = tgp.GligenPipeline(tgp.GligenConfig.tiny(), nets["unet"][1], nets["vae"][1],
                               nets["text"][1], inpaint_unet_params=nets["unet9"][1],
                               tokenizer=tok)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipelines(nets):
    return _pipelines(nets)


def _jax_draws(cfg, steps, inpaint):
    """x_T and the per-step blend noise that the JAX `run` draws from its
    default key PRNGKey(0)."""
    import jax

    rng2, k = jax.random.split(jax.random.PRNGKey(0))
    shape = (1, cfg.latent_size, cfg.latent_size, cfg.unet.out_channels)
    x_t = torch.from_numpy(np.array(jax.random.normal(k, shape)))
    noise = None
    if inpaint:
        noise = torch.from_numpy(np.stack([
            np.asarray(jax.random.normal(jax.random.split(kk)[0], shape))
            for kk in jax.random.split(rng2, steps)]))
    return x_t, noise


CASES = {
    # module, reply, image given, (prompt, boxes, phrases, guidance)
    "A": ("<module>A</module><instruction>a red car on a street</instruction>"
          "<region>[0.1,0.2,0.6,0.8]</region>", False,
          ("a red car on a street", [[0.1, 0.2, 0.6, 0.8]], ["a red car on a street"], 7.5)),
    "C": ("<module>C</module><instruction>a green bus</instruction>"
          "<region>[0.25,0.1,0.75,0.6]</region>", True,
          ("a green bus", [[0.25, 0.1, 0.75, 0.6]], ["a green bus"], 30.0)),
}


@pytest.mark.parametrize("module", ["A", "C"])
def test_route_and_image_match_jax(nets, pipelines, module):
    """`VitronSystem.route` reaches the port's handle_a / handle_c with the JAX
    system's status, task and image shape; and the port's `run` given the
    JAX run's own draws (x_T, blend noise) returns the JAX image to within 1
    uint8 level."""
    from vitron_tpu.runtime.router import route_model_output
    from vitron_tpu.runtime.system import VitronSystem as JSystem

    jpipe, tpipe = pipelines
    reply, with_image, (prompt, boxes, phrases, gs) = CASES[module]
    image = (np.random.RandomState(8).randint(0, 256, (40, 48, 3), np.uint8)
             if with_image else None)
    jsys = JSystem(None)
    jsys.register_gligen(jpipe)
    want = route_model_output(jsys.registry, reply, image=image)
    tsys = VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=8 << 30))
    tsys.register_gligen(tpipe)
    with torch.no_grad():
        got = tsys.route(reply, image=image)
    for key in ("status", "task", "text"):
        assert got[key] == want[key], key
    assert got["status"] == "ok"
    assert got["image"].shape == want["image"].shape == (32, 32, 3)
    assert got["image"].dtype == want["image"].dtype == np.uint8

    cfg = nets["cfg"]
    lat = cfg.latent_size
    keep = None
    if with_image:  # handle_c's keep-mask for region boxes
        gy, gx = np.mgrid[0:lat, 0:lat]
        b = boxes[0]
        keep = (~((gx >= b[0] * lat) & (gx < b[2] * lat) & (gy >= b[1] * lat)
                  & (gy < b[3] * lat))).astype(np.float32)
    inputs = tpipe.prepare(prompt, boxes, phrases, inpaint_image=image, inpaint_keep_mask=keep)
    x_t, noise = _jax_draws(cfg, cfg.steps, with_image)
    with torch.no_grad():
        img = tpipe.run(**inputs, x_t=x_t, steps=cfg.steps, guidance_scale=gs,
                        alpha_type=(0.3, 0.0, 0.7), blend_noise=noise).numpy()
    jimg = np.asarray(want["image"]).astype(np.int32)
    assert jimg.std() > 10  # not a flat image
    assert np.abs(img.astype(np.int32) - jimg).max() <= 1


_SKETCH = np.zeros((40, 48), bool)
_SKETCH[10:25, 5:30] = True
BRANCHES = {
    # reply, image given, sketch mask
    "A_region": (CASES["A"][0], False, None),
    "A_no_region": ("<module>A</module><instruction>a cat</instruction>", False, None),
    "C_region": (CASES["C"][0], True, None),
    "C_sketch": ("<module>C</module><instruction>a green bus; a red car</instruction>", True,
                 _SKETCH),
    "C_default": ("<module>C</module><instruction>a green bus; a red car</instruction>", True,
                  None),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_handlers_call_generate_as_jax(pipelines, monkeypatch, branch):
    """Each branch of handle_a / handle_c (region boxes, none, a sketch, the
    default box) hands `generate` the JAX handler's prompt, boxes, phrases,
    guidance, source image and keep-mask, and returns its status and shape."""
    from vitron_tpu.runtime.router import route_model_output
    from vitron_tpu.runtime.system import VitronSystem as JSystem

    jpipe, tpipe = pipelines
    reply, with_image, sketch = BRANCHES[branch]
    image = (np.random.RandomState(9).randint(0, 256, (40, 48, 3), np.uint8)
             if with_image else None)
    calls = {"jax": [], "port": []}
    for name, pipe in (("jax", jpipe), ("port", tpipe)):
        def generate(*args, _orig=pipe.generate, _calls=calls[name], **kw):
            _calls.append((args, kw))
            return _orig(*args, **kw)

        monkeypatch.setattr(pipe, "generate", generate)
    jsys = JSystem(None)
    jsys.register_gligen(jpipe)
    want = route_model_output(jsys.registry, reply, image=image, sketch_mask=sketch)
    tsys = VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=8 << 30))
    tsys.register_gligen(tpipe)
    with torch.no_grad():
        got = tsys.route(reply, image=image, sketch_mask=sketch)
    for key in ("status", "task", "text"):
        assert got[key] == want[key], key
    assert got["status"] == "ok" and got["image"].shape == want["image"].shape
    (jargs, jkw), = calls["jax"]
    (targs, tkw), = calls["port"]
    assert targs[0] == jargs[0] and list(targs[2]) == list(jargs[2])
    np.testing.assert_allclose(np.asarray(targs[1], np.float64).reshape(-1, 4),
                               np.asarray(jargs[1], np.float64).reshape(-1, 4))
    assert tkw["guidance_scale"] == jkw["guidance_scale"]
    for key in ("inpaint_image", "inpaint_keep_mask"):
        tv, jv = tkw.get(key), jkw.get(key)
        assert (tv is None) == (jv is None), key
        if tv is not None:
            np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv))


def test_route_without_backend_is_unavailable():
    out = VitronSystem(None, memory_plan=MemoryPlan(budget_bytes=8 << 30)).route("<module>A</module><instruction>a cat</instruction>")
    assert out["status"] == "unavailable"


def test_stub_tokenizer_is_deterministic():
    tok = StubClipTokenizer(49408)
    ids = tok(["a red car", "a red car"], max_length=8)["input_ids"]
    np.testing.assert_array_equal(ids[0], ids[1])
    assert ids[0, 0] == 49406 and ids[0, 4] == 49407 and ids.shape == (2, 8)
    np.testing.assert_array_equal(ids[0, 1:4], [1 + __import__("zlib").crc32(w.encode()) % 49405
                                                for w in ("a", "red", "car")])


def test_diffusion_slice_runs_without_jax(tmp_path):
    """A tiny grounded generate and inpaint through the port with `jax`
    unimportable: the port never needs it."""
    script = tmp_path / "run.py"
    script.write_text(f"""
import sys
sys.modules["jax"] = None
sys.path.insert(0, {str(REPO)!r})
import dataclasses
import numpy as np
import torch
from vitron_tpu_torch.models.diffusion import clip_text, gligen_pipeline as gp, unet2d, vae
from vitron_tpu_torch.models.diffusion.synthetic import StubClipTokenizer, fill_zero_leaves
cfg = gp.GligenConfig.tiny()
g = torch.Generator().manual_seed(0)
u9 = dataclasses.replace(cfg.unet, in_channels=9)
pipe = gp.GligenPipeline(cfg, *[fill_zero_leaves(p, g) for p in (
    unet2d.init_params(g, cfg.unet, "cpu"), vae.init_params(g, cfg.vae, "cpu"),
    clip_text.init_params(g, cfg.text, "cpu"))],
    inpaint_unet_params=fill_zero_leaves(unet2d.init_params(g, u9, "cpu"), g),
    tokenizer=StubClipTokenizer(cfg.text.vocab_size))
with torch.no_grad():
    a = pipe.generate("a cat", [[0.1, 0.1, 0.5, 0.5]], ["a cat"], steps=2)
    c = pipe.generate("a dog", [[0.2, 0.2, 0.8, 0.8]], ["a dog"], steps=2,
                      inpaint_image=np.zeros((32, 32, 3), np.uint8))
assert a.shape == c.shape == (32, 32, 3) and "jax" not in [m for m in sys.modules if sys.modules[m]]
print("ok")
""")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
