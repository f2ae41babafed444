"""Parity of the port's SEEM checkpoint converters (ROADMAP A7c) with the JAX
package's, on the CPU.

No SEEM checkpoint is in the repository and the vendored reference that
`tests/synthetic_weights.build_seem` needs is absent, so every state dict
here is written by the port's own writer (`synthetic.seem_state_dict`, or
`synthetic.reference_state_dict` on a converter's `layers.KeyMap` key map)
from a tree whose values come from numpy at a seed (`_numpy_tree`: the
port's init gives the structure). The JAX converter judges the writer: on
that dict it must give the tree the dict was written from, bit for bit,
with the key paths and shapes of JAX's own init, so a key that the port's
converter and its writer both got wrong still fails.

Each of the eight converters (FocalNet, the pixel decoder, the language
encoder, the decoder, the whole model, Swin, DaViT at the port's
`DaViTConfig()` (C13) and at its tiny config, ResNet) is held against its
JAX twin in float32, fp16 and bf16 (both widen each entry to float32
exactly), with keys beside it that no converter reads; the optional keys
(FocalNet's layerscale gammas, the decoder's `mask_sptial_embed`,
ResNet's shortcut) absent and present; a `seem_focall_v1.pt` on disk
through the port's mapped reader and JAX's `load_torch_bin`; and
`segment_text` on the two converted trees within the SEEM slice's
tolerance (`test_torch_seem.RTOL`, 1e-4 of the largest JAX logit, no
attention-mask bit flipped).
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from test_torch_seem import RTOL, _close, _flipped, _image, _JaxAttnMasks, _phrase_ids
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion import synthetic
from vitron_tpu_torch.models.diffusion.layers import KeyMap
from vitron_tpu_torch.models.llm.loader import load_torch_pth
from vitron_tpu_torch.models.seem import davit as tdavit
from vitron_tpu_torch.models.seem import decoder as tdec
from vitron_tpu_torch.models.seem import focalnet as tfocal
from vitron_tpu_torch.models.seem import language as tlang
from vitron_tpu_torch.models.seem import model as tmodel
from vitron_tpu_torch.models.seem import pixel_decoder as tpix
from vitron_tpu_torch.models.seem import resnet as tresnet
from vitron_tpu_torch.models.seem import swin as tswin
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

HALF = {"float32": None, "fp16": torch.float16, "bf16": torch.bfloat16}
SEEM = tmodel.SeemConfig.tiny()


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{path}{key}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree) for k, v in _flat(sub, f"{path}{i}/").items()}
    return {path: tree}


def _assert_same(got, want, what: str) -> None:
    """The same key paths, and at each a tensor of the same dtype, shape and
    bits."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), (what, sorted(g.keys() ^ w.keys())[:5])
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, (what, k)
        assert torch.equal(g[k], w[k]), (what, k)


def _walk(fn, tree):
    if isinstance(tree, dict):
        return {k: _walk(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v) for v in tree)
    return fn(tree)


def _numpy_tree(tree, seed: int):
    """`tree`'s structure with values from numpy at `seed`: a constant leaf
    (a norm's scale or bias, a bias, a layerscale gamma, BatchNorm
    statistics, logit_scale) becomes the constant plus N(0, 0.1^2), any
    other leaf N(0, std^2) at its own init's std (fan-in scaled)."""
    rs = np.random.RandomState(seed)

    def leaf(t):
        a = t.numpy()
        if a.size and np.all(a == a.flat[0]):
            out = a.flat[0] + 0.1 * rs.standard_normal(a.shape)
        else:
            out = rs.standard_normal(a.shape) * a.std()
        return torch.from_numpy(np.asarray(out, np.float32))

    return _walk(leaf, tree)


def _rounded(tree, dtype):
    """Each leaf rounded to `dtype` and widened back: what a half-precision
    file holds of the tree."""
    return tree if dtype is None else _walk(lambda t: t.to(dtype).float(), tree)


def _jax_tree(tree):
    import jax

    return from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _jmod(name: str):
    return importlib.import_module(f"vitron_tpu.models.seem.{name}")


def _jcfg(mod_name: str, cls: str, cfg):
    """The JAX package's config with the port config's field values."""
    jcls = getattr(_jmod(mod_name), cls)
    return jcls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(jcls)
                   if hasattr(cfg, f.name)})


DAVIT_T = tdavit.DaViTConfig()

# name -> (port converter, JAX module and function, port config, its JAX config
# maker, the port init, the JAX init's config maker)
PARTS = {
    "focalnet": (tfocal.convert_torch, ("focalnet", "convert_torch"), SEEM.backbone,
                 lambda: _jmod("model").SeemConfig.tiny().backbone,
                 lambda g: tfocal.init_params(g, SEEM.backbone, "cpu")),
    "pixel_decoder": (tpix.convert_torch, ("pixel_decoder", "convert_torch"), SEEM.pixel,
                      lambda: _jmod("model").SeemConfig.tiny().pixel,
                      lambda g: tpix.init_params(g, SEEM.pixel, "cpu")),
    "language": (tlang.convert_torch, ("language", "convert_torch"), SEEM.lang,
                 lambda: _jmod("model").SeemConfig.tiny().lang,
                 lambda g: tlang.init_params(g, SEEM.lang, "cpu")),
    "decoder": (tmodel.convert_decoder_torch, ("model", "convert_decoder_torch"), SEEM.decoder,
                lambda: _jmod("model").SeemConfig.tiny().decoder,
                lambda g: tdec.init_params(g, SEEM.decoder, "cpu")),
    "model": (tmodel.convert_torch, ("model", "convert_torch"), SEEM,
              lambda: _jmod("model").SeemConfig.tiny(),
              lambda g: tmodel.init_params(g, SEEM, "cpu")),
    "swin": (tswin.convert_torch, ("swin", "convert_torch"), tswin.SwinConfig.tiny(),
             lambda: _jmod("swin").SwinConfig.tiny(),
             lambda g: tswin.init_params(g, tswin.SwinConfig.tiny(), "cpu")),
    "davit_tiny": (tdavit.convert_torch, ("davit", "convert_torch"), tdavit.DaViTConfig.tiny(),
                   lambda: _jmod("davit").DaViTConfig.tiny(),
                   lambda g: tdavit.init_params(g, tdavit.DaViTConfig.tiny(), "cpu")),
    "davit_t": (tdavit.convert_torch, ("davit", "convert_torch"), DAVIT_T,
                lambda: _jcfg("davit", "DaViTConfig", DAVIT_T),
                lambda g: tdavit.init_params(g, DAVIT_T, "cpu")),
    "resnet": (tresnet.convert_torch, ("resnet", "convert_torch"), tresnet.ResNetConfig.tiny(),
               lambda: _jmod("resnet").ResNetConfig.tiny(),
               lambda g: tresnet.init_params(g, tresnet.ResNetConfig.tiny(), "cpu")),
}
# the JAX init of each part's config, for the key paths and shapes
JAX_INIT = {"focalnet": ("focalnet", "init_params"), "pixel_decoder": ("pixel_decoder", "init_params"),
            "language": ("language", "init_params"), "decoder": ("decoder", "init_params"),
            "model": ("model", "init_params"), "swin": ("swin", "init_params"),
            "davit_tiny": ("davit", "init_params"), "davit_t": ("davit", "init_params"),
            "resnet": ("resnet", "init_params")}


def _extras():
    """Keys no converter reads, as a released seem_focall_v1.pt carries
    them: buffers beside the weights, an int64 counter, the criterion's
    float64 weight."""
    return {"backbone.layers.0.blocks.0.attn_mask": torch.zeros(4, 4),
            "sem_seg_head.predictor.lang_encoder.lang_encoder.attn_mask": torch.ones(3, 3),
            "backbone.num_batches_tracked": torch.tensor(5),
            "criterion.empty_weight": torch.ones(7, dtype=torch.float64)}


def _written(name: str, seed: int, dtype=None):
    """(the numpy-valued tree, its reference-layout state dict with the
    extra keys) of part `name`."""
    convert, _, cfg, _, init = PARTS[name]
    tree = _numpy_tree(init(torch.Generator().manual_seed(seed)), seed)
    sd = synthetic.reference_state_dict(convert(KeyMap(), cfg), tree, dtype=dtype)
    return tree, {**sd, **_extras()}


@pytest.mark.parametrize("dtype", list(HALF))
@pytest.mark.parametrize("name", list(PARTS))
def test_converter_matches_jax(name, dtype):
    """The port's converter and JAX's on one written dict: every leaf
    bit-equal, and equal to the tree written (rounded to the file's
    precision); the key paths and shapes of JAX's init at that config."""
    import jax

    convert, (jmod, jfn), cfg, jcfg, _ = PARTS[name]
    tree, sd = _written(name, seed=3, dtype=HALF[dtype])
    got = convert(sd, cfg)
    want = _jax_tree(getattr(_jmod(jmod), jfn)(sd, jcfg()))
    _assert_same(got, want, f"{name} {dtype} against JAX")
    _assert_same(got, _rounded(tree, HALF[dtype]), f"{name} {dtype} against the tree written")
    imod, ifn = JAX_INIT[name]
    init = _jax_tree(getattr(_jmod(imod), ifn)(jax.random.PRNGKey(0), jcfg()))
    gi, wi = _flat(got), _flat(init)
    assert gi.keys() == wi.keys(), sorted(gi.keys() ^ wi.keys())[:5]
    assert all(gi[k].shape == wi[k].shape for k in wi)


@pytest.mark.parametrize("name", ["model", "swin", "resnet"])
def test_converter_reads_on_its_device_one_entry_at_a_time(name):
    """`device=` puts every leaf there; a KeyMap gives the key map, which
    the writer reads the other way to the same dict."""
    convert, _, cfg, _, _ = PARTS[name]
    tree, sd = _written(name, seed=4)
    got = convert(sd, cfg, device="cpu")
    assert all(t.device.type == "cpu" for t in _flat(got).values())
    again = synthetic.reference_state_dict(convert(KeyMap(), cfg), got)
    assert again.keys() == {k: v for k, v in sd.items() if k not in _extras()}.keys()
    assert all(torch.equal(again[k], sd[k]) for k in again)


OPTIONAL = {
    # part, the keys to drop, the leaf paths the converters then omit (or zero)
    "gamma": ("focalnet", ("gamma_1", "gamma_2")),
    "mask_sptial_embed": ("decoder", ("mask_sptial_embed.",)),
    "downsample": ("resnet", ("downsample.",)),
}


@pytest.mark.parametrize("case", list(OPTIONAL))
def test_optional_keys_absent(case):
    """Without FocalNet's gammas, the decoder's `mask_sptial_embed.{i}` or
    ResNet's shortcut both converters give the same tree: no gamma, zero
    mask_spatial_embed leaves, no w_sc / bn_sc."""
    name, dropped = OPTIONAL[case]
    convert, (jmod, jfn), cfg, jcfg, _ = PARTS[name]
    tree, sd = _written(name, seed=5)
    sd = {k: v for k, v in sd.items() if not any(d in k for d in dropped)}
    got = convert(sd, cfg)
    _assert_same(got, _jax_tree(getattr(_jmod(jmod), jfn)(sd, jcfg())), f"{case} absent")
    paths = _flat(got)
    if case == "gamma":
        assert not any("gamma" in k for k in paths)
    elif case == "mask_sptial_embed":
        embeds = got["mask_spatial_embed"]
        assert len(embeds) == cfg.num_feature_levels
        assert all(e.shape == (cfg.hidden_dim, cfg.hidden_dim) and not e.any() for e in embeds)
    else:
        assert not any("_sc" in k for k in paths)
        assert any("_sc" in k for k in _flat(tree))


def test_seem_file_through_both_loaders(tmp_path):
    """seem_focall_v1.pt as fp16 on disk: the port maps it
    (`load_torch_pth`) and converts, JAX reads it with `load_torch_bin`;
    the same leaves."""
    from vitron_tpu.models.llm import loader as jloader
    from vitron_tpu.models.seem import model as jmodel

    tree = _numpy_tree(tmodel.init_params(torch.Generator().manual_seed(6), SEEM, "cpu"), 6)
    path = tmp_path / "seem_focall_v1.pt"
    torch.save({**synthetic.seem_state_dict(tree, SEEM, dtype=torch.float16), **_extras()}, path)
    got = tmodel.convert_torch(load_torch_pth(path), SEEM)
    jtree = jmodel.convert_torch(jloader.load_torch_bin(str(path)), jmodel.SeemConfig.tiny())
    # JAX's load_torch_bin widens bf16 only, so its leaves stay fp16; the
    # port widens every half-precision entry to float32 on its device
    assert {np.asarray(a).dtype for a in _flat(jtree).values()} == {np.dtype(np.float16)}
    want = _walk(lambda t: t.float(), _jax_tree(jtree))
    _assert_same(got, want, "seem_focall_v1.pt")
    _assert_same(got, _rounded(tree, torch.float16), "seem_focall_v1.pt against the tree")


@pytest.mark.parametrize("words", [3, 6])
def test_segment_text_on_converted_trees(monkeypatch, words):
    """`segment_text` on the port's conversion against JAX's on its own
    conversion of the same dict: mask logits within RTOL, no attention-mask
    bit flipped, the same matched mask."""
    import jax.numpy as jnp

    from vitron_tpu.models.seem import model as jmodel

    tree, sd = _written("model", seed=7)
    tp = tmodel.convert_torch(sd, SEEM)
    jcfg = jmodel.SeemConfig.tiny()
    jp = jmodel.convert_torch(sd, jcfg)
    image = _image(8)
    ids, mask = _phrase_ids(SEEM, words, seed=9 + words)
    rec = _JaxAttnMasks(monkeypatch)
    with tdec.recording_attn_masks() as masks:
        want, want_out = jmodel.segment_text(jp, jcfg, jnp.asarray(image), jnp.asarray(ids),
                                             jnp.asarray(mask))
        got, got_out = tmodel.segment_text(tp, SEEM, torch.as_tensor(image),
                                           torch.as_tensor(ids), torch.as_tensor(mask))
    flips, _ = _flipped(rec, masks)
    assert flips == 0, f"{flips} attention-mask bits flipped"
    _close(got, np.asarray(want), RTOL)
    assert np.array_equal(np.asarray(got) > 0, np.asarray(want) > 0)
