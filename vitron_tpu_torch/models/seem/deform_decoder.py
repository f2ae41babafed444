"""Deformable pixel decoder (the MSDeformAttn variant).

Port of `vitron_tpu/models/seem/deform_decoder.py` (:32-193; reference
MSDeformAttnPixelDecoder, modules/SEEM/demo_code/xdecoder/body/encoder/
transformer_encoder_deform.py): the top `num_transformer_levels` features,
each through a 1x1 input projection and GroupNorm, flatten into one token
stream with sine and level position embeddings; each encoder layer runs
MSDeformAttn self-attention (per-query offsets around the reference points
on every level, softmax weights, the bilinear gather of
`kernels.ms_deform_attn`) and a ReLU FFN, post-norm; the tokens go back to
per-level maps, the lower levels get a lateral 1x1 conv and an output 3x3
conv with a bilinear top-down upsample (`media.preprocess._resize_hw`,
`jax.image.resize`'s linear weights), and a last 3x3 conv gives the mask
features.

Every GroupNorm is `pixel_decoder._gn`, whose sums are the hand CUDA
group-norm kernel on the card: one launch for each input projection and two
for each FPN level (5 on Swin-L's four maps). The JAX package has no
converter for this decoder, and the port has none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from vitron_tpu_torch.kernels.ms_deform_attn import ms_deform_attn
from vitron_tpu_torch.media.preprocess import _resize_hw
from vitron_tpu_torch.models.seem.pixel_decoder import _conv, _gn, _ln, position_embedding_sine


@dataclasses.dataclass(frozen=True)
class DeformDecoderConfig:
    conv_dim: int = 512
    mask_dim: int = 512
    num_layers: int = 6
    num_heads: int = 8
    num_points: int = 4
    dim_feedforward: int = 1024
    in_channels: Tuple[int, ...] = (192, 384, 768, 1536)  # res2..res5 of Swin-L
    num_transformer_levels: int = 3                        # res3..res5
    gn_groups: int = 32

    @staticmethod
    def tiny(**kw) -> "DeformDecoderConfig":
        base = dict(conv_dim=32, mask_dim=32, num_layers=2, num_heads=4, num_points=2,
                    dim_feedforward=64, in_channels=(16, 32), num_transformer_levels=1)
        base.update(kw)
        return DeformDecoderConfig(**base)


def ms_deform_attn_module(p: Dict[str, Any], query: torch.Tensor, reference_points: torch.Tensor,
                          value_tokens: torch.Tensor, spatial_shapes, num_heads: int,
                          num_points: int) -> torch.Tensor:
    """MSDeformAttn: project the values, predict each query's sampling
    offsets and softmax weights, gather, project out."""
    b, lq, c = query.shape
    n_levels = len(spatial_shapes)
    d = c // num_heads
    value = (value_tokens @ p["value_w"] + p["value_b"]).reshape(b, -1, num_heads, d)
    offsets = (query @ p["off_w"] + p["off_b"]).reshape(b, lq, num_heads, n_levels,
                                                        num_points, 2)
    weights = (query @ p["attw_w"] + p["attw_b"]).reshape(b, lq, num_heads,
                                                          n_levels * num_points)
    weights = torch.softmax(weights, dim=-1).reshape(b, lq, num_heads, n_levels, num_points)
    normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                              device=query.device)
    locs = (reference_points[:, :, None, :, None, :]
            + offsets / normalizer[None, None, None, :, None, :])
    return ms_deform_attn(value, spatial_shapes, locs, weights) @ p["out_w"] + p["out_b"]


def _reference_points(spatial_shapes) -> np.ndarray:
    """[sum HW, L, 2] normalized pixel centres of every level (all inputs
    unpadded, so every valid ratio is 1)."""
    pts = []
    for h, w in spatial_shapes:
        gy, gx = np.meshgrid((np.arange(h) + 0.5) / h, (np.arange(w) + 0.5) / w, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    ref = np.concatenate(pts, 0).astype(np.float32)
    return np.broadcast_to(ref[:, None], (ref.shape[0], len(spatial_shapes), 2)).copy()


def forward_features(params: Dict[str, Any], cfg: DeformDecoderConfig,
                     features: List[torch.Tensor]):
    """features [res2..resN] NHWC -> (mask_features, the first three maps of
    the top-down outputs)."""
    n = len(features)
    ntl = cfg.num_transformer_levels
    srcs, poss, shapes = [], [], []
    for i, f in enumerate(features[n - ntl:][::-1]):  # top-down: res5 .. res3
        b, h, w, _ = f.shape
        proj = params["input_proj"][i]
        x = _gn(_conv(f, proj["w"], proj["b"]), proj["norm"], cfg.gn_groups)
        srcs.append(x.reshape(b, h * w, cfg.conv_dim))
        pos = position_embedding_sine(h, w, cfg.conv_dim, device=f.device).to(f.dtype)
        poss.append(pos[None] + params["level_embed"][i])
        shapes.append((h, w))
    src = torch.cat(srcs, dim=1)
    pos = torch.cat(poss, dim=1)
    ref = torch.from_numpy(_reference_points(shapes)).to(src.device)[None]
    for lp in params["layers"]:
        att = ms_deform_attn_module(lp["attn"], src + pos, ref, src, shapes, cfg.num_heads,
                                    cfg.num_points)
        src = _ln(src + att, lp["norm1"])
        h2 = torch.relu(src @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
        src = _ln(src + h2, lp["norm2"])
    outs = []
    off = 0
    for h, w in shapes:
        outs.append(src[:, off:off + h * w].reshape(-1, h, w, cfg.conv_dim))
        off += h * w
    y = outs[-1]
    for i, f in enumerate(features[:n - ntl][::-1]):
        lvl = params["fpn"][i]
        cur = _gn(_conv(f, lvl["lat_w"], None), lvl["lat_norm"], cfg.gn_groups)
        up = _resize_hw(y, cur.shape[1], cur.shape[2], "linear")
        y = torch.relu(_gn(_conv(cur + up, lvl["out_w"], None, padding=1), lvl["out_norm"],
                           cfg.gn_groups))
        outs.append(y)
    return _conv(outs[-1], params["mask_w"], params["mask_b"], padding=1), outs[:3]


def init_params(gen: torch.Generator, cfg: DeformDecoderConfig, device) -> Dict[str, Any]:
    """Random params with the JAX init's shapes and scales; the sampling
    offsets start as the reference's ring grid (zero weights, bias pointing
    each head in its own direction, farther for each point)."""
    cd = cfg.conv_dim
    n_levels = cfg.num_transformer_levels
    heads, pts = cfg.num_heads, cfg.num_points

    def dense(cin, cout):
        return torch.randn((cin, cout), generator=gen, device=device) * cin ** -0.5

    def conv(kh, kw, cin, cout):
        return (torch.randn((kh, kw, cin, cout), generator=gen, device=device)
                * (kh * kw * cin) ** -0.5)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def norm():
        return {"scale": torch.ones((cd,), device=device), "bias": zeros(cd)}

    thetas = np.arange(heads) * (2 * np.pi / heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None], (1, n_levels, pts, 1))
    for p_i in range(pts):
        grid[:, :, p_i] *= p_i + 1
    off_bias = torch.tensor(grid.reshape(-1), dtype=torch.float32, device=device)

    def attn():
        return {"value_w": dense(cd, cd), "value_b": zeros(cd),
                "off_w": zeros(cd, heads * n_levels * pts * 2), "off_b": off_bias.clone(),
                "attw_w": zeros(cd, heads * n_levels * pts),
                "attw_b": zeros(heads * n_levels * pts),
                "out_w": dense(cd, cd), "out_b": zeros(cd)}

    n_fpn = len(cfg.in_channels) - n_levels
    input_proj = [{"w": conv(1, 1, cin, cd), "b": zeros(cd), "norm": norm()}
                  for cin in cfg.in_channels[n_fpn:][::-1]]
    level_embed = torch.randn((n_levels, cd), generator=gen, device=device) * 0.02
    layers = [{"attn": attn(), "norm1": norm(), "norm2": norm(),
               "fc1_w": dense(cd, cfg.dim_feedforward), "fc1_b": zeros(cfg.dim_feedforward),
               "fc2_w": dense(cfg.dim_feedforward, cd), "fc2_b": zeros(cd)}
              for _ in range(cfg.num_layers)]
    fpn = [{"lat_w": conv(1, 1, cin, cd), "lat_norm": norm(), "out_w": conv(3, 3, cd, cd),
            "out_norm": norm()} for cin in cfg.in_channels[:n_fpn][::-1]]
    return {"input_proj": input_proj, "level_embed": level_embed, "layers": layers, "fpn": fpn,
            "mask_w": conv(3, 3, cd, cfg.mask_dim), "mask_b": zeros(cfg.mask_dim)}
