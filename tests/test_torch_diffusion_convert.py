"""Parity of the port's diffusion checkpoint converters (ROADMAP A7b) with the
JAX package's, on the CPU at tiny configs.

No released checkpoint is in the repository, so each state dict is written
in the reference's key layout by the port's own writer
(`synthetic.reference_state_dict`: a converter's key map read the other
way) from a live port tree (the port's init, every zero leaf filled from a
seed), with keys beside it that no converter reads. The JAX converter then
judges the writer: on that dict it must give the tree the dict was written
from, bit for bit, with the key paths and shapes of JAX's own init at that
config, so a key that the port's converter and its writer both got wrong
still fails. Each converter is held:
- at every prefix the reference's files put its keys under;
- in float32, fp16 and bf16 (the port widens each entry to float32
  exactly; JAX's MiDaS converter keeps fp16 and cannot read bf16, so there
  the port is held to its own float32 conversion of the widened dict).
End to end: tiny GLIGEN bundles (generation and inpainting, with a pickled
config of a class no process can import) through both packages' loaders
and pipelines (images within 1 uint8 level on JAX's draws, as
`test_torch_diffusion.py::test_route_and_image_match_jax` holds them), and
tiny t2v / i2vgen `.pth` files through both converters and one UNet forward
(within `test_torch_video.py`'s UNET_TOL).
"""
import dataclasses
import functools
import sys
import types

import numpy as np
import pytest
import torch

from test_torch_diffusion import CASES as ROUTES
from test_torch_diffusion import _jax_draws
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion import clip_text as tct
from vitron_tpu_torch.models.diffusion import controlnet as tcn
from vitron_tpu_torch.models.diffusion import depth as tdp
from vitron_tpu_torch.models.diffusion import gligen_pipeline as tgp
from vitron_tpu_torch.models.diffusion import grounding_nets as tgn
from vitron_tpu_torch.models.diffusion import layers as tl
from vitron_tpu_torch.models.diffusion import stablevideo as tsv
from vitron_tpu_torch.models.diffusion import synthetic
from vitron_tpu_torch.models.diffusion import unet2d as tun
from vitron_tpu_torch.models.diffusion import unet_sd_video as tusv
from vitron_tpu_torch.models.diffusion import vae as tvae
from vitron_tpu_torch.models.diffusion.layers import KeyMap
from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves, reference_state_dict
from vitron_tpu_torch.models.llm.loader import load_torch_pth
from vitron_tpu_torch.runtime.memory_plan import MemoryPlan
from vitron_tpu_torch.runtime.system import VitronSystem
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

UNET_TOL = 1e-3  # max |port - JAX| / max |JAX| of a whole video UNet forward, float32
HALF = {"fp16": torch.float16, "bf16": torch.bfloat16}


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{path}{i}/"))
        return out
    return {path: tree}


def _widened(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.dtype in (torch.float16, torch.bfloat16) else t


def _assert_same(got, want, what: str) -> None:
    """The same key paths, and at each a float32 (or integer) tensor with
    the same bits."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), (what, sorted(g.keys() ^ w.keys())[:5])
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (what, k, g[k].dtype,
                                                                       w[k].dtype)
        assert torch.equal(g[k], w[k]), (what, k)


def _jax_tree(tree):
    """A JAX converter's output as port tensors, fp16 widened to float32."""
    import jax

    return from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32)
                                 if np.asarray(a).dtype == np.float16 else np.asarray(a), tree),
                    "cpu")


def _live(tree, seed: int):
    return fill_zero_leaves(tree, torch.Generator().manual_seed(seed))


def _extras(prefix: str):
    """Keys no converter reads, as released files carry them: an EMA's
    counters, the scheduler's float64 betas, an int64 buffer under the
    converter's own prefix."""
    return {"model_ema.decay": torch.tensor(0.9999), "model_ema.num_updates": torch.tensor(7),
            "betas": torch.linspace(1e-4, 2e-2, 10, dtype=torch.float64),
            prefix + "num_batches_tracked": torch.tensor(3)}


# ------------------------------------------------------------------ configs


def _jcfg(mod_name: str, cfg):
    """The JAX package's config of the same fields."""
    import importlib

    mod = importlib.import_module(f"vitron_tpu.models.diffusion.{mod_name}")
    cls = {"unet2d": "UNetConfig", "vae": "VAEConfig", "clip_text": "TextConfig",
           "unet_sd_video": "UNetSDVideoConfig", "depth": "DPTConfig"}[mod_name]
    return getattr(mod, cls)(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})


def _jmod(name: str):
    import importlib

    return importlib.import_module(f"vitron_tpu.models.diffusion.{name}")


def _key():
    import jax

    return jax.random.PRNGKey(0)


UNET = tun.UNetConfig.tiny()
UNET9 = dataclasses.replace(UNET, in_channels=9)
VAE = tvae.VAEConfig.tiny()
TEXT = tct.TextConfig.tiny()
T2V = tusv.UNetSDVideoConfig.tiny("t2v", use_fps_condition=True)
I2V = tusv.UNetSDVideoConfig.tiny("i2vgen")
DPT_HYBRID = tdp.DPTConfig.tiny()
# tests/test_depth_parity.py's tiny dpt_large
DPT_LARGE = tdp.DPTConfig.dpt_large(image_size=64, hidden_size=32, num_layers=4, num_heads=4,
                                    mlp_dim=64, hooks=(0, 1, 2, 3), features=16,
                                    reassemble_dims=(8, 16, 32, 32))
CONVNEXT_DEPTHS, CONVNEXT_DIMS = (1, 1, 2, 1), (8, 16, 24, 32)
IMLP = tsv.IMLPConfig(hidden_dim=16, num_layers=4, positional_dim=4, skip_layers=(2,))


def _down_tree(cin: int):
    g = torch.Generator().manual_seed(41)
    return {"conv1_w": torch.randn((4, 4, cin, 4), generator=g),
            "conv1_b": torch.randn((4,), generator=g),
            "conv2_w": torch.randn((4, 4, 4, 8), generator=g),
            "conv2_b": torch.randn((8,), generator=g)}


@dataclasses.dataclass(frozen=True)
class Case:
    """One converter: a live port tree, its key map, the port's and JAX's
    converters called on (state dict, prefix), JAX's init (None where JAX has
    none), the prefixes the reference's files use, whether JAX's converter
    reads bf16."""

    tree: callable
    key_map: callable
    port: callable
    jax: callable
    jax_init: callable = None
    prefixes: tuple = ("",)
    jax_bf16: bool = True


CASES = {
    # layers.py: every block converter is reached through these
    "spatial_transformer": Case(
        lambda: _live(tun.init_params(torch.Generator().manual_seed(1), UNET, "cpu"), 2)
        ["input_blocks"][1][1],
        lambda: tl.convert_spatial_transformer(KeyMap(), ""),
        lambda sd, p: tl.convert_spatial_transformer(sd, p),
        lambda sd, p: _jmod("layers").convert_spatial_transformer(sd, p),
        lambda: _jmod("unet2d").init_params(_key(), _jcfg("unet2d", UNET))["input_blocks"][1][1],
        ("input_blocks.1.1.", "model.diffusion_model.input_blocks.1.1.")),
    "position_net": Case(
        lambda: _live(tun.init_params(torch.Generator().manual_seed(3), UNET, "cpu"),
                      4)["position_net"],
        lambda: tl.convert_position_net(KeyMap(), ""),
        lambda sd, p: tl.convert_position_net(sd, p),
        lambda sd, p: _jmod("layers").convert_position_net(sd, p),
        lambda: _jmod("unet2d").init_params(_key(), _jcfg("unet2d", UNET))["position_net"],
        ("position_net.", "model.diffusion_model.position_net.")),
    "position_net_with_image": Case(
        lambda: _live(tun.init_position_net_with_image(torch.Generator().manual_seed(5), UNET,
                                                       "cpu"), 6),
        lambda: tl.convert_position_net_with_image(KeyMap(), ""),
        lambda sd, p: tl.convert_position_net_with_image(sd, p),
        lambda sd, p: _jmod("layers").convert_position_net_with_image(sd, p),
        None, ("position_net.",)),
    "clip_text": Case(
        lambda: _live(tct.init_params(torch.Generator().manual_seed(7), TEXT, "cpu"), 8),
        lambda: tct.convert_hf_clip_text(KeyMap(), TEXT),
        lambda sd, p: tct.convert_hf_clip_text(sd, TEXT),
        lambda sd, p: _jmod("clip_text").convert_hf_clip_text(sd, _jcfg("clip_text", TEXT)),
        lambda: _jmod("clip_text").init_params(_key(), _jcfg("clip_text", TEXT)),
        ("text_model.", "transformer.text_model.", "cond_stage_model.transformer.text_model.")),
    "vae": Case(
        lambda: _live(tvae.init_params(torch.Generator().manual_seed(9), VAE, "cpu"), 10),
        lambda: tvae.convert_ldm_vae(KeyMap(), VAE),
        lambda sd, p: tvae.convert_ldm_vae(sd, VAE),
        lambda sd, p: _jmod("vae").convert_ldm_vae(sd, _jcfg("vae", VAE)),
        lambda: _jmod("vae").init_params(_key(), _jcfg("vae", VAE)),
        ("", "first_stage_model.")),
    "unet2d_gligen": Case(
        lambda: _live(tun.init_params(torch.Generator().manual_seed(11), UNET, "cpu"), 12),
        lambda: tun.convert_ldm_unet(KeyMap(), UNET),
        lambda sd, p: tun.convert_ldm_unet(sd, UNET),
        lambda sd, p: _jmod("unet2d").convert_ldm_unet(sd, _jcfg("unet2d", UNET)),
        lambda: _jmod("unet2d").init_params(_key(), _jcfg("unet2d", UNET)),
        ("", "model.diffusion_model.")),
    "unet2d_inpaint": Case(
        lambda: _live(tun.init_params(torch.Generator().manual_seed(13), UNET9, "cpu"), 14),
        lambda: tun.convert_ldm_unet(KeyMap(), UNET9),
        lambda sd, p: tun.convert_ldm_unet(sd, UNET9),
        lambda sd, p: _jmod("unet2d").convert_ldm_unet(sd, _jcfg("unet2d", UNET9)),
        lambda: _jmod("unet2d").init_params(_key(), _jcfg("unet2d", UNET9)),
        ("", "model.diffusion_model.")),
    "unet2d_sd": Case(
        lambda: _live(tun.init_params(torch.Generator().manual_seed(15), UNET, "cpu",
                                      grounding=False), 16),
        lambda: tun.convert_ldm_unet(KeyMap(), UNET),
        lambda sd, p: tun.convert_ldm_unet(sd, UNET),
        lambda sd, p: _jmod("unet2d").convert_ldm_unet(sd, _jcfg("unet2d", UNET)),
        lambda: _jmod("unet2d").init_params(_key(), _jcfg("unet2d", UNET), grounding=False),
        ("", "model.diffusion_model.")),
    "video_t2v": Case(
        lambda: _live(tusv.init_params(torch.Generator().manual_seed(17), T2V, "cpu"), 18),
        lambda: tusv.convert_torch(KeyMap(), T2V),
        lambda sd, p: tusv.convert_torch(sd, T2V),
        lambda sd, p: _jmod("unet_sd_video").convert_torch(sd, _jcfg("unet_sd_video", T2V)),
        lambda: _jmod("unet_sd_video").init_params(_key(), _jcfg("unet_sd_video", T2V)),
        ("", "module.")),
    "video_i2vgen": Case(
        lambda: _live(tusv.init_params(torch.Generator().manual_seed(19), I2V, "cpu"), 20),
        lambda: tusv.convert_torch(KeyMap(), I2V),
        lambda sd, p: tusv.convert_torch(sd, I2V),
        lambda sd, p: _jmod("unet_sd_video").convert_torch(sd, _jcfg("unet_sd_video", I2V)),
        lambda: _jmod("unet_sd_video").init_params(_key(), _jcfg("unet_sd_video", I2V)),
        ("", "module.")),
    "controlnet": Case(
        lambda: _live(tcn.init_params(torch.Generator().manual_seed(21), UNET, "cpu"), 22),
        lambda: tcn.convert_torch(KeyMap(), UNET),
        lambda sd, p: tcn.convert_torch(sd, UNET, prefix=p),
        lambda sd, p: _jmod("controlnet").convert_torch(sd, _jcfg("unet2d", UNET), prefix=p),
        lambda: _jmod("controlnet").init_params(_key(), _jcfg("unet2d", UNET)),
        ("control_model.", "")),
    "imlp": Case(
        lambda: _live(tsv.imlp_init(torch.Generator().manual_seed(23), IMLP, "cpu"), 24),
        None,
        lambda sd, p: tsv.convert_imlp_torch(sd, p),
        lambda sd, p: _jmod("stablevideo").convert_imlp_torch(sd, p),
        lambda: _jmod("stablevideo").imlp_init(_key(), _jmod("stablevideo").IMLPConfig(
            **dataclasses.asdict(IMLP))),
        ("", "model_F_mapping1.")),
    "midas_hybrid": Case(
        lambda: _live(tdp.init_params(torch.Generator().manual_seed(25), DPT_HYBRID, "cpu"), 26),
        lambda: tdp.convert_midas_torch(KeyMap(), DPT_HYBRID),
        lambda sd, p: tdp.convert_midas_torch(sd, DPT_HYBRID),
        lambda sd, p: _jmod("depth").convert_midas_torch(sd, _jcfg("depth", DPT_HYBRID)),
        lambda: _jmod("depth").init_params(_key(), _jcfg("depth", DPT_HYBRID)),
        ("", "model."), jax_bf16=False),
    "midas_large": Case(
        lambda: _live(tdp.init_params(torch.Generator().manual_seed(27), DPT_LARGE, "cpu"), 28),
        lambda: tdp.convert_midas_torch(KeyMap(), DPT_LARGE),
        lambda sd, p: tdp.convert_midas_torch(sd, DPT_LARGE),
        lambda sd, p: _jmod("depth").convert_midas_torch(sd, _jcfg("depth", DPT_LARGE)),
        lambda: _jmod("depth").init_params(_key(), _jcfg("depth", DPT_LARGE)),
        ("", "model."), jax_bf16=False),
    "convnext": Case(
        lambda: _live(tgn.convnext_init(torch.Generator().manual_seed(29), "cpu",
                                        CONVNEXT_DEPTHS, CONVNEXT_DIMS), 30),
        lambda: tgn.convert_convnext_torch(KeyMap(), "", CONVNEXT_DEPTHS),
        lambda sd, p: tgn.convert_convnext_torch(sd, p, CONVNEXT_DEPTHS),
        lambda sd, p: _jmod("grounding_nets").convert_convnext_torch(sd, p, CONVNEXT_DEPTHS),
        lambda: _jmod("grounding_nets").convnext_init(_key(), CONVNEXT_DEPTHS, CONVNEXT_DIMS),
        ("convnext_tiny_backbone.", "position_net.convnext_tiny_backbone.")),
    "hint_net": Case(
        lambda: _live(tgn.init_hint_position_net(torch.Generator().manual_seed(31), "cpu",
                                                 resize_input=64), 32),
        lambda: tgn.convert_hint_position_net(KeyMap(), ""),
        lambda sd, p: tgn.convert_hint_position_net(sd, p),
        lambda sd, p: _jmod("grounding_nets").convert_hint_position_net(sd, p),
        lambda: _jmod("grounding_nets").init_hint_position_net(_key(), resize_input=64),
        ("position_net.",)),
    "sem_net": Case(
        lambda: _live(tgn.init_hint_position_net(torch.Generator().manual_seed(33), "cpu",
                                                 resize_input=64, in_dim=5), 34),
        lambda: tgn.convert_hint_position_net(KeyMap(), ""),
        lambda sd, p: tgn.convert_hint_position_net(sd, p),
        lambda sd, p: _jmod("grounding_nets").convert_hint_position_net(sd, p),
        lambda: _jmod("grounding_nets").init_hint_position_net(_key(), resize_input=64, in_dim=5),
        ("position_net.",)),
    "keypoint_net": Case(
        lambda: _live(tgn.init_keypoint_position_net(torch.Generator().manual_seed(35), "cpu"),
                      36),
        lambda: tgn.convert_keypoint_position_net(KeyMap(), ""),
        lambda sd, p: tgn.convert_keypoint_position_net(sd, p),
        lambda sd, p: _jmod("grounding_nets").convert_keypoint_position_net(sd, p),
        lambda: _jmod("grounding_nets").init_keypoint_position_net(_key()),
        ("position_net.",)),
    "downsampler": Case(
        lambda: _down_tree(3),
        lambda: tgn.convert_grounding_downsampler(KeyMap(), ""),
        lambda sd, p: tgn.convert_grounding_downsampler(sd, p),
        lambda sd, p: _jmod("grounding_nets").convert_grounding_downsampler(sd, p),
        None, ("downsample_net.",)),
}


@functools.lru_cache(maxsize=None)
def _tree(name: str):
    return CASES[name].tree()


def _write(name: str, prefix: str, dtype=None):
    """The case's tree as a reference state dict under `prefix`, with keys
    no converter reads; the IMLP in the released NLA naming (`hidden.{i}`),
    the ControlNet inside a whole ControlLDM dict when under its prefix."""
    c, tree = CASES[name], _tree(name)
    if name == "imlp":
        sd = synthetic.imlp_state_dict(tree, prefix, dtype=dtype)
    elif name == "controlnet" and prefix:
        g = torch.Generator().manual_seed(37)
        sd = synthetic.controlldm_state_dict(
            _live(tun.init_params(g, UNET, "cpu", grounding=False), 38), tree,
            _live(tvae.init_params(g, VAE, "cpu"), 39),
            _live(tct.init_params(g, tct.TextConfig.tiny(hidden_size=UNET.context_dim), "cpu"),
                  40), UNET, VAE, tct.TextConfig.tiny(hidden_size=UNET.context_dim), dtype)
    else:
        sd = reference_state_dict(c.key_map(), tree, prefix, dtype)
    return {**_extras(prefix), **sd}


CASE_PREFIXES = [(n, p) for n, c in CASES.items() for p in c.prefixes]


@pytest.mark.parametrize("name,prefix", CASE_PREFIXES,
                         ids=[f"{n}-{p or 'bare'}" for n, p in CASE_PREFIXES])
def test_converter_matches_jax_on_the_written_dict(name, prefix):
    """The port's converter and JAX's give the written tree back, bit for
    bit, at each prefix of the reference's files."""
    c = CASES[name]
    sd = _write(name, prefix)
    port = c.port(sd, prefix)
    _assert_same(port, _tree(name), f"{name}: port")
    _assert_same(_jax_tree(c.jax(sd, prefix)), _tree(name), f"{name}: JAX")


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("name", sorted(CASES))
def test_half_precision_dicts_widen_exactly(name, half):
    """fp16 / bf16 files: every entry widened to float32 exactly, as JAX's
    converter reads them (MiDaS's JAX converter keeps fp16 and refuses bf16:
    there the port is held to its float32 conversion of the widened dict)."""
    c, prefix = CASES[name], CASES[name].prefixes[-1]
    sd = _write(name, prefix, HALF[half])
    want = {k: _widened(v.to(HALF[half])) for k, v in _flat(_tree(name)).items()}
    port = c.port(sd, prefix)
    assert _flat(port).keys() == want.keys()
    for k, v in _flat(port).items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), (name, k)
    if c.jax_bf16 or half == "fp16":
        _assert_same(_jax_tree(c.jax(sd, prefix)), port, f"{name}: JAX, {half}")
    else:
        _assert_same(c.port({k: _widened(v) for k, v in sd.items()}, prefix), port, name)


@pytest.mark.parametrize("name", sorted(n for n, c in CASES.items() if c.jax_init))
def test_written_layout_is_the_one_jax_reads(name):
    """JAX's converter on the written dict gives JAX's own init tree at that
    config: the same key paths and shapes."""
    c = CASES[name]
    prefix = c.prefixes[0]
    got = {k: tuple(v.shape) for k, v in _flat(_jax_tree(c.jax(_write(name, prefix), prefix)))
           .items()}
    want = {k: tuple(np.shape(v)) for k, v in _flat(c.jax_init()).items()}
    assert got == want


def test_transformer_block_without_its_fuser():
    """`with_fuser=False` leaves a dict's fuser out, as JAX's does."""
    block = _tree("spatial_transformer")["blocks"][0]
    sd = reference_state_dict(tl.convert_transformer_block(KeyMap(), "b."), block)
    got = tl.convert_transformer_block(sd, "b.", with_fuser=False)
    want = _jax_tree(_jmod("layers").convert_transformer_block(sd, "b.", with_fuser=False))
    assert "fuser" in block and "fuser" not in got
    _assert_same(got, want, "block")
    _assert_same(got, {k: v for k, v in block.items() if k != "fuser"}, "block")


@pytest.mark.parametrize("stem", tsv.IMLP_STEMS)
def test_imlp_stems(stem):
    """The released NLA naming and the two other IMLP exports."""
    sd = synthetic.imlp_state_dict(_tree("imlp"), "m.", stem)
    _assert_same(tsv.convert_imlp_torch(sd, "m."), _tree("imlp"), stem)
    _assert_same(_jax_tree(_jmod("stablevideo").convert_imlp_torch(sd, "m.")), _tree("imlp"), stem)
    with pytest.raises(ValueError, match="no IMLP layers"):
        tsv.convert_imlp_torch(sd, "other.")
    with pytest.raises(ValueError, match="no IMLP layers"):  # no keys to find layers from
        tsv.convert_imlp_torch(KeyMap())


def test_sample_latent_matches_jax():
    import jax
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    mean, logvar = rs.randn(2, 4, 4, 4).astype(np.float32), rs.randn(2, 4, 4, 4).astype(np.float32)
    k = jax.random.PRNGKey(3)
    want = _jmod("vae").sample_latent(k, jnp.asarray(mean), jnp.asarray(logvar))
    noise = torch.from_numpy(np.array(jax.random.normal(k, mean.shape, jnp.float32)))
    got = tvae.sample_latent(torch.from_numpy(mean), torch.from_numpy(logvar), noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ GLIGEN bundles


@pytest.fixture(scope="module")
def gligen(tmp_path_factory):
    """A tiny GLIGEN config, its live trees, and its generation and
    inpainting bundles saved with a config entry whose class no process can
    import once they are written."""
    cfg = tgp.GligenConfig.tiny()
    g = torch.Generator().manual_seed(50)
    trees = {"unet": _live(tun.init_params(g, cfg.unet, "cpu"), 51),
             "unet9": _live(tun.init_params(g, dataclasses.replace(cfg.unet, in_channels=9),
                                            "cpu"), 52),
             "vae": _live(tvae.init_params(g, cfg.vae, "cpu"), 53),
             "text": _live(tct.init_params(g, cfg.text, "cpu"), 54)}
    d = tmp_path_factory.mktemp("gligen")
    paths = {}
    for name, unet, inpaint in (("generation", "unet", False), ("inpainting", "unet9", True)):
        paths[name] = d / f"gligen_{name}.pth"
        synthetic.save_with_absent_config(
            synthetic.gligen_bundle(trees[unet], trees["vae"], trees["text"], cfg, inpaint),
            paths[name], model={"target": "ldm.models.diffusion.ddpm.LatentDiffusion"})
    assert synthetic.ABSENT_MODULE not in sys.modules
    return cfg, trees, paths


def _absent_module():
    """The config's module, for JAX's loader: it unpickles the whole bundle
    (`weights_only=False`), as on a machine where the config's class imports."""
    module = types.ModuleType(synthetic.ABSENT_MODULE)
    module.DictConfig = type("DictConfig", (), {"__module__": synthetic.ABSENT_MODULE})
    return module


def test_gligen_bundle_with_an_unimportable_config_loads(gligen):
    """The port reads the bundle without importing the config's class (a
    weights-only load refuses it, a plain unpickle fails to import it), and
    each tree comes back bit for bit; a bundle without 'model' raises."""
    from vitron_tpu_torch.models.llm.loader import load_torch_bundle

    cfg, trees, paths = gligen
    with pytest.raises(Exception, match="Weights only load failed"):
        torch.load(paths["generation"], weights_only=True)
    with pytest.raises(ModuleNotFoundError, match=synthetic.ABSENT_MODULE):
        torch.load(paths["generation"], weights_only=False)
    bundle = load_torch_bundle(paths["generation"])
    assert type(bundle["config"]).__module__ == synthetic.ABSENT_MODULE
    assert bundle["config"].state == {"model": {"target":
                                                "ldm.models.diffusion.ddpm.LatentDiffusion"}}
    assert synthetic.ABSENT_MODULE not in sys.modules
    for name, unet, inpaint in (("generation", "unet", False), ("inpainting", "unet9", True)):
        u, v, t = tgp.load_gligen_checkpoint(paths[name], cfg, inpaint=inpaint)
        _assert_same(u, trees[unet], name)
        _assert_same(v, trees["vae"], name)
        _assert_same(t, trees["text"], name)

    no_model = paths["generation"].with_name("no_model.pth")
    synthetic.save_with_absent_config({k: v for k, v in bundle.items()
                                       if k not in ("model", "config")}, no_model)
    with pytest.raises(KeyError, match="lacks \\['model'\\]"):
        tgp.load_gligen_checkpoint(no_model, cfg)


class _Planted:
    """Pickles as the call fn(*args), as a hostile checkpoint would plant it."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("call", ["os.system", "builtins.eval", "builtins.exec",
                                  "subprocess.Popen"])
def test_bundle_load_runs_no_planted_call(tmp_path, call):
    """A bundle whose pickle calls an importable function: a plain unpickle
    runs it (the plant is live), the port's bundle reader leaves it an inert
    `_Absent` with its arguments, and the state dict beside it loads."""
    import os
    import subprocess

    from vitron_tpu_torch.models.llm.loader import _Absent, load_torch_bundle

    marker = tmp_path / "ran"
    fn, args = {"os.system": (os.system, (f"touch '{marker}'",)),
                "builtins.eval": (eval, (f"open({str(marker)!r}, 'w').close()",)),
                "builtins.exec": (exec, (f"open({str(marker)!r}, 'w').close()",)),
                "subprocess.Popen": (subprocess.Popen, (["touch", str(marker)],))}[call]
    path = tmp_path / "planted.pth"
    torch.save({"model": {"w": torch.arange(4.0)}, "config": _Planted(fn, args)}, path)
    ran = torch.load(path, weights_only=False)["config"]
    if isinstance(ran, subprocess.Popen):
        ran.wait()
    assert marker.exists(), "the planted call did not run under a plain unpickle"
    marker.unlink()

    bundle = load_torch_bundle(path)
    assert isinstance(bundle["config"], _Absent)
    assert bundle["config"].args == args
    assert torch.equal(bundle["model"]["w"], torch.arange(4.0))
    assert not marker.exists()


@pytest.mark.parametrize("module", ["A", "C"])
def test_loaded_bundles_route_as_jax(gligen, monkeypatch, module):
    """Both packages' loaders and pipelines on the same bundles: the routed
    reply's status, task and image shape, and the port's image from JAX's own
    draws within 1 uint8 level of the JAX route's."""
    from vitron_tpu.models.diffusion import gligen_pipeline as jgp
    from vitron_tpu.runtime.router import route_model_output
    from vitron_tpu.runtime.system import VitronSystem as JSystem

    cfg, _, paths = gligen
    tok = synthetic.StubClipTokenizer(cfg.text.vocab_size)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, synthetic.ABSENT_MODULE, _absent_module())
        ju, jv, jt = jgp.load_gligen_checkpoint(str(paths["generation"]), cfg)
        ju9, _, _ = jgp.load_gligen_checkpoint(str(paths["inpainting"]), cfg, inpaint=True)
    jpipe = jgp.GligenPipeline(cfg, ju, jv, jt, inpaint_unet_params=ju9, tokenizer=tok)
    u, v, t = tgp.load_gligen_checkpoint(paths["generation"], cfg)
    u9, _, _ = tgp.load_gligen_checkpoint(paths["inpainting"], cfg, inpaint=True)
    tpipe = tgp.GligenPipeline(cfg, u, v, t, inpaint_unet_params=u9, tokenizer=tok)

    reply, with_image, (prompt, boxes, phrases, gs) = ROUTES[module]
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
    assert got["image"].shape == want["image"].shape == (32, 32, 3)

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


# ------------------------------------------------------------------ video UNets


def _video_inputs(cfg, seed: int):
    rs = np.random.RandomState(seed)

    def x(*shape):
        return rs.randn(*shape).astype(np.float32)

    a = dict(x=x(2, 3, 8, 8, cfg.in_dim), t=np.asarray([501.0, 17.0], np.float32),
             y=x(2, 5, cfg.context_dim), fps=np.asarray([16.0, 8.0], np.float32))
    if cfg.variant == "i2vgen":
        a.update(image=x(2, cfg.y_dim), local_image=x(2, 8, 8, cfg.in_dim))
    return a


@pytest.mark.parametrize("name,prefix", [("video_t2v", ""), ("video_i2vgen", "module.")])
def test_video_pth_through_both_converters_and_a_forward(name, prefix, tmp_path):
    """A tiny .pth through each package's converter, then one UNet forward of
    each within UNET_TOL."""
    import jax.numpy as jnp

    jusv = _jmod("unet_sd_video")
    cfg = T2V if name == "video_t2v" else I2V
    path = tmp_path / "unet.pth"
    torch.save(_write(name, prefix), path)
    tp = tusv.convert_torch(load_torch_pth(path), cfg)
    _assert_same(tp, _tree(name), name)
    jcfg = _jcfg("unet_sd_video", cfg)
    jp = jusv.convert_torch(torch.load(path, map_location="cpu", weights_only=True), jcfg)
    a = _video_inputs(cfg, 60)
    got = tusv.forward(tp, cfg, **{k: torch.from_numpy(v) for k, v in a.items()})
    want = np.asarray(jusv.forward(jp, jcfg, **{k: jnp.asarray(v) for k, v in a.items()}))
    assert np.abs(want).max() > 0.1  # a live net
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= UNET_TOL
