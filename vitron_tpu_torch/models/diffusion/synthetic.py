"""Synthetic weights, checkpoints, tokenizer and image embedder for the
diffusion tests and smoke runs.

No released checkpoint, CLIP vocabulary or OpenCLIP visual tower is in the
repo, so tests and `chip_smoke.py` run on random weights, stub tokens and a
stub image embedding, and make their checkpoints here: a converter's key map
(the converter run on `layers.KeyMap()`) read the other way writes a port
tree out as a state dict in the reference's key layout
(`reference_state_dict`), and `gligen_bundle` / `controlldm_state_dict` /
`imlp_state_dict` / `seem_state_dict` assemble the reference's files from
such dicts. Nothing on a main path uses them.

`init_params` of the UNet (like the JAX one) zero-initialises each ResNet's
conv2, proj_out, the final out conv, the GLIGEN gates alpha_attn/alpha_dense
and all biases, as training from scratch wants. With those zeros the UNet's
output is identically zero and tanh(0) switches the fuser off, so a parity
check on such a net would pass while testing nothing. `fill_zero_leaves`
gives every all-zero leaf seeded values at init scale instead.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
import types
import zlib
from typing import Any, Dict, List

import numpy as np

import torch

from vitron_tpu_torch.models.diffusion import clip_text, controlnet, unet2d, vae
from vitron_tpu_torch.models.diffusion.layers import LAYOUTS, Key, KeyMap


def fill_zero_leaves(tree: Any, gen: torch.Generator) -> Any:
    """Same structure; each all-zero floating leaf replaced by: U(0.5, 1) for
    a scalar gate (tanh 0.46-0.76), N(0, 0.1^2) for a vector (biases, null
    embeddings), N(0, 1/fan_in) with fan_in = prod(shape[:-1]) for a weight.
    Values are drawn in float32 on `gen`'s device and cast to the leaf's."""
    if isinstance(tree, dict):
        return {k: fill_zero_leaves(v, gen) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(fill_zero_leaves(v, gen) for v in tree)
    if not (tree.is_floating_point() and tree.numel() and not bool(tree.any())):
        return tree
    shape = tuple(tree.shape)
    if tree.dim() == 0:
        w = 0.5 + 0.5 * torch.rand(shape, generator=gen, device=gen.device)
    else:
        w = torch.randn(shape, generator=gen, device=gen.device)
        w = w * (0.1 if tree.dim() == 1 else 1.0 / math.sqrt(math.prod(shape[:-1])))
    return w.to(device=tree.device, dtype=tree.dtype)


class StubClipTokenizer:
    """Deterministic stand-in for the CLIP BPE tokenizer, called as the
    pipeline calls HF's: BOS, one id per whitespace word (crc32 of the word,
    so the same text gives the same ids in every process), EOS, then EOS
    padding to max_length. BOS and EOS are the top two ids of the vocabulary,
    so argmax finds the first EOS, as with CLIP's own ids."""

    def __init__(self, vocab_size: int):
        self.bos, self.eos = vocab_size - 2, vocab_size - 1
        self.n_words = vocab_size - 3

    def __call__(self, texts: List[str], padding="max_length", max_length: int = 77,
                 truncation: bool = True, return_tensors: str = "np") -> Dict[str, np.ndarray]:
        out = np.full((len(texts), max_length), self.eos, np.int64)
        for i, text in enumerate(texts):
            words = [1 + zlib.crc32(w.encode()) % self.n_words for w in text.split()]
            ids = [self.bos] + words[: max_length - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return {"input_ids": out}


class StubImageEmbedder:
    """Deterministic stand-in for the I2V pipeline's global image embedder
    (upstream's OpenCLIP visual tower): uint8 [H, W, 3] -> float32
    [1, y_dim], a fixed random projection (numpy, from `seed`) of the image's
    per-channel means in [0, 1], so the embedding depends on the image and
    the UNet's global tokens are live."""

    def __init__(self, y_dim: int, seed: int = 0):
        self.proj = np.random.RandomState(seed).randn(3, y_dim).astype(np.float32)

    def __call__(self, image) -> np.ndarray:
        means = np.asarray(image, np.float32).reshape(-1, 3).mean(0) / 255.0
        return (means @ self.proj)[None]


# ------------------------------------------------- reference-layout state dicts


def reference_state_dict(key_map, tree, prefix: str = "", dtype=None,
                         device="cpu") -> Dict[str, torch.Tensor]:
    """The inverse of a converter: the port tree `tree` written out at the
    keys of `key_map` (the converter's output on a `KeyMap`) under `prefix`,
    each leaf in the reference's layout, cast to `dtype` (its own when None)
    and copied to `device`. Parts of the map the tree lacks (what a
    converter reads only where the dict has it) are skipped; a tree leaf
    that the map lacks raises."""
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, t: torch.Tensor) -> None:
        # cast where the tree lives, then a tensor of its own on `device`
        out[prefix + key] = t.contiguous().to(dtype or t.dtype).to(device, copy=True)

    def walk(m, t, path: str) -> None:
        if isinstance(t, dict):
            for k, v in t.items():
                if not isinstance(m, dict) or k not in m:
                    raise KeyError(f"{path}{k}: not in the key map")
                walk(m[k], v, f"{path}{k}.")
        elif isinstance(t, (list, tuple)):
            if not isinstance(m, list) or len(m) != len(t):
                raise ValueError(f"{path}: {len(t)} entries, the key map has {m!r:.80}")
            for i, (mi, ti) in enumerate(zip(m, t)):
                walk(mi, ti, f"{path}{i}.")
        else:
            if not isinstance(m, Key):
                raise ValueError(f"{path}: a leaf where the key map has {m!r:.80}")
            inverse = LAYOUTS[m.kind][1]
            if isinstance(m.key, tuple):  # a stacked leaf: one key a row
                for key, row in zip(m.key, t):
                    put(key, inverse(row))
            else:
                put(m.key, inverse(t))

    walk(key_map, tree, "")
    return out


def imlp_state_dict(tree, prefix: str = "", stem: str = "hidden", dtype=None,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """An IMLP tree as the released NLA checkpoints hold it (`hidden.{i}`
    Linears), the inverse of `stablevideo.convert_imlp_torch`."""
    out = {}
    for i, layer in enumerate(tree["layers"]):
        for name, t in (("weight", layer["w"].t()), ("bias", layer["b"])):
            out[f"{prefix}{stem}.{i}.{name}"] = t.contiguous().to(dtype or t.dtype).to(
                device, copy=True)
    return out


def seem_state_dict(params, cfg, dtype=None, device="cpu") -> Dict[str, torch.Tensor]:
    """A SEEM param tree as seem_focall_v1.pt holds it: the backbone under
    'backbone.', the pixel decoder, decoder and language encoder under
    'sem_seg_head.', in the reference's layouts (the inverse of
    `seem.model.convert_torch`)."""
    from vitron_tpu_torch.models.seem import model as seem_model

    return reference_state_dict(seem_model.convert_torch(KeyMap(), cfg), params, dtype=dtype,
                                device=device)


def gligen_bundle(unet, vae_params, text, cfg, inpaint: bool = False,
                  dtype=None) -> Dict[str, Any]:
    """A GLIGEN .pth bundle's entries in the reference's layout: 'model' (the
    UNet with its fusers and position net; 9 input channels with
    `inpaint`), 'autoencoder' and 'text_encoder' (ldm's FrozenCLIPEmbedder
    keys, 'transformer.text_model.'), each with a key no converter reads,
    as released state dicts carry them (the scheduler's `betas`, the VAE
    loss's `loss.logvar`, CLIP's `position_ids` buffer); and a 'diffusion'
    entry of scheduler constants beside them. The weights are cast to
    `dtype` (their own when None)."""
    ucfg = dataclasses.replace(cfg.unet, in_channels=9) if inpaint else cfg.unet
    text_sd = reference_state_dict(clip_text.convert_hf_clip_text(KeyMap(), cfg.text), text,
                                   "transformer.text_model.", dtype=dtype)
    text_sd["transformer.text_model.embeddings.position_ids"] = torch.arange(
        cfg.text.max_length)[None]
    model = reference_state_dict(unet2d.convert_ldm_unet(KeyMap(), ucfg), unet, dtype=dtype)
    model["betas"] = torch.linspace(0.00085, 0.012, 1000)
    autoencoder = reference_state_dict(vae.convert_ldm_vae(KeyMap(), cfg.vae), vae_params,
                                       dtype=dtype)
    autoencoder["loss.logvar"] = torch.zeros(())
    return {"model": model, "autoencoder": autoencoder, "text_encoder": text_sd,
            "diffusion": {"linear_start": 0.00085, "linear_end": 0.012, "timesteps": 1000}}


def controlldm_state_dict(unet, control, vae_params, text, ucfg, vcfg, tcfg, dtype=None,
                          device="cpu") -> Dict[str, torch.Tensor]:
    """One ControlLDM checkpoint (cldm's control_sd15_*.pth) in the
    reference's layout: the UNet under 'model.diffusion_model.', the
    ControlNet under 'control_model.', the VAE under 'first_stage_model.'
    and the text encoder under 'cond_stage_model.transformer.text_model.',
    with the scheduler buffers ('betas', ...) no converter reads."""
    sd = {}
    for key_map, tree, prefix in (
            (unet2d.convert_ldm_unet(KeyMap(), ucfg), unet, "model.diffusion_model."),
            (controlnet.convert_torch(KeyMap(), ucfg), control, "control_model."),
            (vae.convert_ldm_vae(KeyMap(), vcfg), vae_params, "first_stage_model."),
            (clip_text.convert_hf_clip_text(KeyMap(), tcfg), text,
             "cond_stage_model.transformer.text_model.")):
        sd.update(reference_state_dict(key_map, tree, prefix, dtype, device))
    betas = torch.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, device=device) ** 2
    sd["betas"] = betas
    sd["alphas_cumprod"] = torch.cumprod(1.0 - betas, 0)
    return sd


ABSENT_MODULE = "vitron_absent_omegaconf"


def save_with_absent_config(bundle: Dict[str, Any], path, **fields) -> int:
    """torch.save(bundle with a 'config' entry, path) -> bytes written. The
    config is an object of a class that pickles under a module
    (`ABSENT_MODULE`) that exists only while it is saved, as the released
    GLIGEN bundle pickles an OmegaConf config that a machine without
    omegaconf cannot import."""
    module = types.ModuleType(ABSENT_MODULE)
    module.DictConfig = type("DictConfig", (), {"__module__": ABSENT_MODULE})
    config = module.DictConfig()
    config.__dict__.update(fields)
    sys.modules[ABSENT_MODULE] = module
    try:
        torch.save({**bundle, "config": config}, path)
    finally:
        del sys.modules[ABSENT_MODULE]
    return os.path.getsize(path)
