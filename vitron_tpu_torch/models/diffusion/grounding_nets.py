"""GLIGEN grounding-net variants: canny / depth / hed / normal / sem / keypoint.

Port of `vitron_tpu/models/diffusion/grounding_nets.py` (all of it but the
checkpoint converters, which wait for the loaders, ROADMAP A7):

- canny / depth / hed / normal: resize the hint map (nearest) to
  `resize_input`, run a ConvNeXt-T trunk, take its (r/32)^2 grid tokens,
  add a learned position embedding and map them through a 3-layer MLP to
  grounding tokens; a masked-out map takes the learned null feature;
- sem: the same after a 3x3 `in_conv` from the class channels to RGB;
- keypoint: per-person and per-keypoint learned embeddings with Fourier xy;
- downsamplers: a resize (cubic or nearest, no antialias) and two stride-2
  convs, or for hed the resize alone, whose output joins the UNet input.

NHWC layouts and HWIO weights, as in the JAX package. The ConvNeXt 7x7
depthwise convs are `kernels.depthwise_conv.depthwise_conv2d`, the hand CUDA
kernel on the card (one launch a block: 18 for ConvNeXt-T), with the weights
cast to x's dtype; the stem, the downsamples and the in_conv are
`layers.conv2d`. The hint resizes are `media.preprocess._resize_hw`, which
builds `jax.image.resize`'s nearest indices and cubic weights.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels.depthwise_conv import depthwise_conv2d
from vitron_tpu_torch.media.preprocess import _resize_hw
from vitron_tpu_torch.models.diffusion.layers import _mlp3, conv2d, fourier_embed
from vitron_tpu_torch.models.vision.vit import layer_norm

CONVNEXT_TINY_DEPTHS = (3, 3, 9, 3)
CONVNEXT_TINY_DIMS = (96, 192, 384, 768)
KEYPOINTS = 17  # COCO keypoints a person


# ------------------------------------------------------------- ConvNeXt-T


def _ln(x, w, b, eps: float = 1e-6):
    return layer_norm(x, {"scale": w, "bias": b}, eps)


def convnext_forward(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """ConvNeXt feature trunk: [B, H, W, 3] -> [B, H/32, W/32, dims[-1]]."""
    for stage_i, stage in enumerate(params["stages"]):
        ds = params["downsample"][stage_i]
        if stage_i == 0:
            x = conv2d(x, ds["conv_w"], ds["conv_b"], stride=4)
            x = _ln(x, ds["norm_w"], ds["norm_b"])
        else:
            x = _ln(x, ds["norm_w"], ds["norm_b"])
            x = conv2d(x, ds["conv_w"], ds["conv_b"], stride=2)
        for blk in stage:
            h = depthwise_conv2d(x, blk["dw_w"].to(x.dtype), blk["dw_b"])
            h = _ln(h, blk["norm_w"], blk["norm_b"])
            h = F.gelu(h @ blk["pw1_w"] + blk["pw1_b"])
            h = h @ blk["pw2_w"] + blk["pw2_b"]
            x = x + blk["gamma"] * h
    return x


def convnext_init(gen: torch.Generator, device, depths=CONVNEXT_TINY_DEPTHS,
                  dims=CONVNEXT_TINY_DIMS) -> Dict[str, Any]:
    """Random ConvNeXt params at the JAX init's scales."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def conv(kh, kw, cin, cout, groups=1):
        fan = kh * kw * cin // groups
        return normal((kh, kw, cin // groups, cout), 0.02 / math.sqrt(max(fan, 1) / 49))

    def full(n, v):
        return torch.full((n,), float(v), device=device)

    downsample, stages = [], []
    for i, (d, dim) in enumerate(zip(depths, dims)):
        if i == 0:
            downsample.append({"conv_w": conv(4, 4, 3, dim), "conv_b": full(dim, 0),
                               "norm_w": full(dim, 1), "norm_b": full(dim, 0)})
        else:
            downsample.append({"norm_w": full(dims[i - 1], 1), "norm_b": full(dims[i - 1], 0),
                               "conv_w": conv(2, 2, dims[i - 1], dim), "conv_b": full(dim, 0)})
        stages.append([{"dw_w": conv(7, 7, dim, dim, groups=dim), "dw_b": full(dim, 0),
                        "norm_w": full(dim, 1), "norm_b": full(dim, 0),
                        "pw1_w": normal((dim, 4 * dim), 0.02), "pw1_b": full(4 * dim, 0),
                        "pw2_w": normal((4 * dim, dim), 0.02), "pw2_b": full(dim, 0),
                        "gamma": full(dim, 1e-6)} for _ in range(d)])
    return {"downsample": downsample, "stages": stages}


# ---------------------------------------------------------- hint PositionNets


def _resize_square(x: torch.Tensor, size: int, method: str) -> torch.Tensor:
    if x.shape[1] == size and x.shape[2] == size:
        return x
    return _resize_hw(x, size, size, method, antialias=False)


def position_net_hint(p: Dict[str, Any], hint: torch.Tensor, mask: torch.Tensor,
                      resize_input: int = 448) -> torch.Tensor:
    """Shared canny / depth / hed / normal PositionNet: hint [B, H, W, 3] ->
    [B, (r/32)^2, out_dim] grounding tokens; mask [B] (0: the whole map is
    the learned null feature). The sem variant ('in_conv' in p) maps its
    class channels to RGB first."""
    b = hint.shape[0]
    hint = _resize_square(hint, resize_input, "nearest")
    if "in_conv" in p:
        hint = conv2d(hint, p["in_conv"]["w"], p["in_conv"]["b"], padding=1)
    feats = convnext_forward(p["convnext"], hint)
    objs = feats.reshape(b, feats.shape[1] * feats.shape[2], feats.shape[-1])
    m = mask.reshape(-1, 1, 1).to(objs.dtype)
    objs = objs * m + (1.0 - m) * p["null_feature"]
    return _mlp3(p["linears"], objs + p["pos_embedding"])


def position_net_keypoint(p: Dict[str, Any], points: torch.Tensor,
                          masks: torch.Tensor) -> torch.Tensor:
    """Keypoint PositionNet: points [B, max_persons * 17, 2] in [0, 1],
    masks [B, max_persons * 17] -> [B, max_persons * 17, out_dim]."""
    n = points.shape[0]
    max_persons, out_dim = p["person_embeddings"].shape
    person = p["person_embeddings"].repeat_interleave(KEYPOINTS, dim=0)
    keypoint = p["keypoint_embeddings"].repeat(max_persons, 1)
    person = (person + keypoint)[None].expand(n, max_persons * KEYPOINTS, out_dim)
    xy = fourier_embed(points, 8)
    m = masks[..., None].to(xy.dtype)
    person = person * m + (1.0 - m) * p["null_person"]
    xy = xy * m + (1.0 - m) * p["null_xy"]
    return _mlp3(p["linears"], torch.cat([person, xy], dim=-1))


# ------------------------------------------------------------- downsamplers


def grounding_downsampler(p: Dict[str, Any], hint: torch.Tensor, resize_input: int = 256,
                          grayscale: bool = False, mode: str = "bicubic") -> torch.Tensor:
    """canny / normal / sem downsampler: resize, conv s2, SiLU, conv s2.
    hint [B, H, W, C]; canny (grayscale) keeps channel 0."""
    if grayscale:
        hint = hint[..., :1]
    hint = _resize_square(hint, resize_input, {"bicubic": "cubic", "nearest": "nearest"}[mode])
    h = conv2d(hint, p["conv1_w"], p["conv1_b"], stride=2, padding=1)
    return conv2d(F.silu(h), p["conv2_w"], p["conv2_b"], stride=2, padding=1)


def grounding_downsampler_hed(hint: torch.Tensor) -> torch.Tensor:
    """hed: the grayscale map resized (cubic, no antialias) to 64 x 64."""
    return _resize_square(hint[..., :1], 64, "cubic")


# ------------------------------------------------------------------ init


def _mlp3_init(normal, zeros, cin: int, out_dim: int, hidden: int = 512) -> Dict[str, Any]:
    return {"w0": normal((cin, hidden), cin ** -0.5), "b0": zeros(hidden),
            "w1": normal((hidden, hidden), hidden ** -0.5), "b1": zeros(hidden),
            "w2": normal((hidden, out_dim), hidden ** -0.5), "b2": zeros(out_dim)}


def init_hint_position_net(gen: torch.Generator, device, resize_input: int = 448,
                           out_dim: int = 768, in_dim: int = 0) -> Dict[str, Any]:
    """Random hint PositionNet params (ConvNeXt-T trunk); in_dim > 0 adds the
    sem variant's in_conv from in_dim class channels."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    c = CONVNEXT_TINY_DIMS[-1]
    p = {"convnext": convnext_init(gen, device),
         "pos_embedding": normal((1, (resize_input // 32) ** 2, c), 0.02),
         "null_feature": zeros(c),
         "linears": _mlp3_init(normal, zeros, c, out_dim)}
    if in_dim:
        p["in_conv"] = {"w": normal((3, 3, in_dim, 3), (9 * in_dim) ** -0.5), "b": zeros(3)}
    return p


def init_keypoint_position_net(gen: torch.Generator, device, max_persons: int = 8,
                               out_dim: int = 768) -> Dict[str, Any]:
    """Random keypoint PositionNet params (zero embeddings, as at init)."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    pos_dim = 8 * 2 * 2
    return {"person_embeddings": zeros(max_persons, out_dim),
            "keypoint_embeddings": zeros(KEYPOINTS, out_dim),
            "null_person": zeros(out_dim), "null_xy": zeros(pos_dim),
            "linears": _mlp3_init(normal, zeros, out_dim + pos_dim, out_dim)}
