"""Swin Transformer backbone (SEEM's alternative to FocalNet).

Port of `vitron_tpu/models/seem/swin.py` (:22-201; reference:
modules/SEEM/demo_code/xdecoder/backbone/swin.py): window attention with a
relative position bias, shifted windows with the cyclic-roll mask on odd
blocks, patch merging between stages, per-stage output norms. The window
stays fixed at every stage, as in the vendored block, and a feature map
that is not a multiple of it is zero-padded before the partition and
cropped after. Windows fold into the batch for one attention product a
block; logits and softmax are float32. No kernel runs here: the JAX package
computes Swin with XLA ops. `window_partition` / `window_reverse` also serve
DaViT. The checkpoint converter waits for the loaders (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitron_tpu_torch.models.seem.pixel_decoder import _ln


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    embed_dim: int = 192             # Swin-L
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    patch_size: int = 4

    @property
    def dims(self):
        return tuple(self.embed_dim * 2 ** i for i in range(len(self.depths)))

    @staticmethod
    def swin_l(**kw) -> "SwinConfig":
        return SwinConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "SwinConfig":
        base = dict(embed_dim=16, depths=(1, 2), num_heads=(2, 4), window_size=4)
        base.update(kw)
        return SwinConfig(**base)


def _rel_pos_index(w: int) -> np.ndarray:
    """Relative position index [w*w, w*w] into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nw, w*w, C]."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    """[B*nw, w*w, C] -> [B, h, ww, C]."""
    b = x.shape[0] // ((h // w) * (ww // w))
    x = x.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


def _attn_mask_for_shift(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Cyclic-shift window mask [nw, w*w, w*w], additive: -100 where two
    tokens come from different regions of the rolled map, else 0."""
    img = np.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = window_partition(torch.from_numpy(img), window).numpy()[:, :, 0]
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _window_attention(p, x, heads: int, rel_idx, mask=None):
    """x [nW, N, C]; the relative position bias added per head, the shift
    mask per window."""
    nw, n, c = x.shape
    d = c // heads
    q, k, v = (x @ p["qkv_w"] + p["qkv_b"]).chunk(3, dim=-1)
    q = q.reshape(nw, n, heads, d).transpose(1, 2) * (d ** -0.5)
    k = k.reshape(nw, n, heads, d).transpose(1, 2)
    v = v.reshape(nw, n, heads, d).transpose(1, 2)
    attn = (q @ k.transpose(2, 3)).to(torch.float32)
    bias = p["rel_bias"][rel_idx.reshape(-1)].reshape(n, n, heads)
    attn = attn + bias.permute(2, 0, 1)[None].to(torch.float32)
    if mask is not None:
        nm = mask.shape[0]
        attn = (attn.reshape(nw // nm, nm, heads, n, n) + mask[None, :, None]).reshape(
            nw, heads, n, n)
    attn = torch.softmax(attn, dim=-1).to(v.dtype)
    out = (attn @ v).transpose(1, 2).reshape(nw, n, c)
    return out @ p["proj_w"] + p["proj_b"]


def forward(params: Dict[str, Any], cfg: SwinConfig, pixels: torch.Tensor) -> List[torch.Tensor]:
    """pixels [B, H, W, 3] (normalized) -> [res2..res5] NHWC features."""
    b, H, W, _ = pixels.shape
    dev = pixels.device
    p4 = cfg.patch_size
    x = pixels.reshape(b, H // p4, p4, W // p4, p4, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, (H // p4) * (W // p4), p4 * p4 * 3) @ params["patch_w"] + params["patch_b"]
    x = _ln(x, params["patch_norm"])
    h, w = H // p4, W // p4
    window = cfg.window_size
    shift = window // 2
    rel_idx = torch.from_numpy(_rel_pos_index(window)).to(dev)
    outs = []
    for si, stage in enumerate(params["stages"]):
        hp, wp = -h % window, -w % window
        hh, ww = h + hp, w + wp
        shift_mask = torch.from_numpy(_attn_mask_for_shift(hh, ww, window, shift)).to(dev)
        for bi, blk in enumerate(stage["blocks"]):
            do_shift = shift if bi % 2 == 1 else 0
            xn = _ln(x, blk["norm1"]).reshape(b, h, w, -1)
            if hp or wp:
                xn = F.pad(xn, (0, 0, 0, wp, 0, hp))
            if do_shift:
                xn = torch.roll(xn, (-do_shift, -do_shift), dims=(1, 2))
            att = _window_attention(blk["attn"], window_partition(xn, window),
                                    cfg.num_heads[si], rel_idx, shift_mask if do_shift else None)
            xn = window_reverse(att, window, hh, ww)
            if do_shift:
                xn = torch.roll(xn, (do_shift, do_shift), dims=(1, 2))
            x = x + xn[:, :h, :w].reshape(b, h * w, -1)
            xn = _ln(x, blk["norm2"])
            x = x + F.gelu(xn @ blk["fc1_w"] + blk["fc1_b"]) @ blk["fc2_w"] + blk["fc2_b"]
        outs.append(_ln(x, params["out_norms"][si]).reshape(b, h, w, -1))
        if "merge_w" in stage:
            xm = x.reshape(b, h, w, -1)
            xm = torch.cat([xm[:, 0::2, 0::2], xm[:, 1::2, 0::2], xm[:, 0::2, 1::2],
                            xm[:, 1::2, 1::2]], dim=-1)
            h, w = h // 2, w // 2
            x = _ln(xm.reshape(b, h * w, -1), stage["merge_norm"]) @ stage["merge_w"]
    return outs


def init_params(gen: torch.Generator, cfg: SwinConfig, device) -> Dict[str, Any]:
    """Random params with the JAX init's shapes and scales."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def dense(cin, cout):
        return normal((cin, cout), cin ** -0.5)

    def zeros(n):
        return torch.zeros((n,), device=device)

    def ln(c):
        return {"scale": torch.ones((c,), device=device), "bias": zeros(c)}

    stages = []
    for si, depth in enumerate(cfg.depths):
        c = cfg.dims[si]
        hidden = int(c * cfg.mlp_ratio)
        blocks = [{"norm1": ln(c), "norm2": ln(c),
                   "attn": {"qkv_w": dense(c, 3 * c), "qkv_b": zeros(3 * c),
                            "rel_bias": normal(((2 * cfg.window_size - 1) ** 2,
                                                cfg.num_heads[si]), 0.02),
                            "proj_w": dense(c, c), "proj_b": zeros(c)},
                   "fc1_w": dense(c, hidden), "fc1_b": zeros(hidden),
                   "fc2_w": dense(hidden, c), "fc2_b": zeros(c)} for _ in range(depth)]
        stage = {"blocks": blocks}
        if si < len(cfg.depths) - 1:
            stage["merge_norm"] = ln(4 * c)
            stage["merge_w"] = dense(4 * c, 2 * c)
        stages.append(stage)
    return {"patch_w": dense(cfg.patch_size ** 2 * 3, cfg.embed_dim),
            "patch_b": zeros(cfg.embed_dim), "patch_norm": ln(cfg.embed_dim),
            "stages": stages, "out_norms": [ln(c) for c in cfg.dims]}
