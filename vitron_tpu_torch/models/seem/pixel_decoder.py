"""FPN pixel decoder with a transformer encoder on res5.

Port of `vitron_tpu/models/seem/pixel_decoder.py` (:23-186), the reference
TransformerEncoderPixelDecoder (modules/SEEM/demo_code/xdecoder/body/
encoder/transformer_encoder_fpn.py:23-330; conv_dim = mask_dim = 512,
GroupNorm 32, 6 post-norm encoder layers, in features res2..res5): sine
position embeddings, FPN top-down nearest 2x upsampling.

Every GroupNorm goes through `models/diffusion/layers.group_norm` (eps
1e-5), whose statistics are the hand CUDA group-norm kernel on the card:
one launch for res5's output norm and two (lateral, output) for each lower
level. Returns (mask_features, multi_scale [res5_y, res4_y, res3_y]).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch

from vitron_tpu_torch.models.diffusion.layers import conv2d, group_norm, upsample2x_nearest
from vitron_tpu_torch.models.vision.vit import layer_norm


@dataclasses.dataclass(frozen=True)
class PixelDecoderConfig:
    conv_dim: int = 512
    mask_dim: int = 512
    num_enc_layers: int = 6
    num_heads: int = 8
    dim_feedforward: int = 2048
    in_channels: Tuple[int, ...] = (192, 384, 768, 1536)  # res2..res5
    gn_groups: int = 32

    @staticmethod
    def tiny(**kw) -> "PixelDecoderConfig":
        base = dict(conv_dim=32, mask_dim=32, num_enc_layers=2, num_heads=4,
                    dim_feedforward=64, in_channels=(16, 32))
        base.update(kw)
        return PixelDecoderConfig(**base)


def position_embedding_sine(h: int, w: int, dim: int, temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """DETR PositionEmbeddingSine(normalize=True) -> [h*w, dim] float32."""
    half = dim // 2
    f32 = torch.float32
    y = torch.arange(1, h + 1, dtype=f32, device=device)[:, None]
    x = torch.arange(1, w + 1, dtype=f32, device=device)[None, :]
    eps = 1e-6
    scale = 2 * math.pi
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    i = torch.arange(half, dtype=f32, device=device)
    dim_t = temperature ** (2 * torch.div(i, 2, rounding_mode="floor") / half)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])],
                        dim=-1).reshape(1, w, half)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])],
                        dim=-1).reshape(h, 1, half)
    return torch.cat([pos_y.expand(h, w, half), pos_x.expand(h, w, half)],
                     dim=-1).reshape(h * w, dim)


def _conv(x, w, b=None, stride=1, padding=0):
    return conv2d(x, w, b, stride=stride, padding=padding)


def _gn(x, p, groups):
    return group_norm(x, p["scale"], p["bias"], groups=groups, eps=1e-5)


def _ln(x, p, eps=1e-5):
    return layer_norm(x, p, eps)


def _mha(q, k, v, p, heads):
    """torch nn.MultiheadAttention equivalent: packed in_proj, out_proj,
    float32 softmax."""
    e = q.shape[-1]
    d = e // heads
    wq, wk, wv = p["in_w"].chunk(3, dim=1)
    bq, bk, bv = p["in_b"].chunk(3, dim=0)
    qq = (q @ wq + bq).reshape(q.shape[0], q.shape[1], heads, d)
    kk = (k @ wk + bk).reshape(k.shape[0], k.shape[1], heads, d)
    vv = (v @ wv + bv).reshape(v.shape[0], v.shape[1], heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", qq, kk).to(torch.float32) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(vv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv).reshape(q.shape[0], q.shape[1], e)
    return out @ p["out_w"] + p["out_b"]


def _encoder_layer(p, src, pos, heads):
    """DETR post-norm encoder layer: q = k = src + pos."""
    q = src + pos
    src = _ln(src + _mha(q, q, src, p["attn"], heads), p["norm1"])
    h = torch.relu(src @ p["fc1_w"] + p["fc1_b"])
    return _ln(src + h @ p["fc2_w"] + p["fc2_b"], p["norm2"])


def forward_features(params: Dict[str, Any], cfg: PixelDecoderConfig,
                     features: List[torch.Tensor]):
    """features: [res2..res5] NHWC -> (mask_features [B, H/4, W/4, mask_dim],
    multi_scale [res5_y, res4_y, res3_y] in conv_dim)."""
    n = len(features)
    multi_scale = []
    y = None
    for idx in range(n - 1, -1, -1):  # top-down: res5 first
        x = features[idx]
        lvl = params["levels"][idx]
        if idx == n - 1:
            b, h, w, _ = x.shape
            src = _conv(x, lvl["input_proj_w"], lvl["input_proj_b"])
            pos = position_embedding_sine(h, w, cfg.conv_dim, device=x.device).to(src.dtype)[None]
            t = src.reshape(b, h * w, cfg.conv_dim)
            for enc in params["encoder"]:
                t = _encoder_layer(enc, t, pos, cfg.num_heads)
            t = t.reshape(b, h, w, cfg.conv_dim)
            y = torch.relu(_gn(_conv(t, lvl["out_w"], lvl.get("out_b"), padding=1),
                               lvl["out_norm"], cfg.gn_groups))
        else:
            cur = _gn(_conv(x, lvl["lat_w"], lvl.get("lat_b")), lvl["lat_norm"], cfg.gn_groups)
            if cur.shape[1:3] != (2 * y.shape[1], 2 * y.shape[2]):
                raise ValueError(f"FPN level {idx}: {tuple(cur.shape)} is not twice the level "
                                 f"above {tuple(y.shape)} (the input side must be a multiple "
                                 f"of 32)")
            y = cur + upsample2x_nearest(y)
            y = torch.relu(_gn(_conv(y, lvl["out_w"], lvl.get("out_b"), padding=1),
                               lvl["out_norm"], cfg.gn_groups))
        if len(multi_scale) < 3:
            multi_scale.append(y)
    mask_features = _conv(y, params["mask_w"], params["mask_b"], padding=1)
    return mask_features, multi_scale


def init_params(gen: torch.Generator, cfg: PixelDecoderConfig, device) -> Dict[str, Any]:
    """Random-init param tree with the JAX package's shapes and scales."""
    cd = cfg.conv_dim

    def dense(cin, cout):
        return torch.randn((cin, cout), generator=gen, device=device) * cin ** -0.5

    def conv(kh, kw, cin, cout):
        return (torch.randn((kh, kw, cin, cout), generator=gen, device=device)
                * (kh * kw * cin) ** -0.5)

    def zeros(n):
        return torch.zeros((n,), device=device)

    def norm(c):
        return {"scale": torch.ones((c,), device=device), "bias": zeros(c)}

    levels = []
    for idx, cin in enumerate(cfg.in_channels):
        if idx == len(cfg.in_channels) - 1:
            levels.append({"input_proj_w": conv(1, 1, cin, cd), "input_proj_b": zeros(cd),
                           "out_w": conv(3, 3, cd, cd), "out_norm": norm(cd)})
        else:
            levels.append({"lat_w": conv(1, 1, cin, cd), "lat_norm": norm(cd),
                           "out_w": conv(3, 3, cd, cd), "out_norm": norm(cd)})
    encoder = []
    for _ in range(cfg.num_enc_layers):
        encoder.append({
            "attn": {"in_w": dense(cd, 3 * cd), "in_b": zeros(3 * cd),
                     "out_w": dense(cd, cd), "out_b": zeros(cd)},
            "norm1": norm(cd), "norm2": norm(cd),
            "fc1_w": dense(cd, cfg.dim_feedforward), "fc1_b": zeros(cfg.dim_feedforward),
            "fc2_w": dense(cfg.dim_feedforward, cd), "fc2_b": zeros(cd),
        })
    return {"levels": levels, "encoder": encoder,
            "mask_w": conv(3, 3, cd, cfg.mask_dim), "mask_b": zeros(cfg.mask_dim)}
