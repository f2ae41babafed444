"""Multi-scale deformable attention (MSDeformAttn), forward.

Port of `vitron_tpu/kernels/ms_deform_attn.py` (:24-79). The reference's
custom CUDA op (an im2col gather, ms_deform_im2col_cuda.cuh) became a
vectorized bilinear gather and a weighted sum in JAX, with no `pallas_call`;
so its port is plain PyTorch (index arithmetic and `torch.gather`), not a
hand kernel, and it counts no launches. Semantics are those of
`F.grid_sample(mode='bilinear', padding_mode='zeros', align_corners=False)`
per level: a sample's four neighbours outside the map contribute zero. The
weighted sum accumulates in float32, as in JAX.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _bilinear_zeros(value: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """value [B, H, W, C]; x / y [B, Q] pixel coordinates (align_corners=False
    space) -> [B, Q, C]; out-of-bounds neighbours give zero."""
    b, h, w, c = value.shape
    flat = value.reshape(b, h * w, c)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    wx0, wy0 = 1.0 - wx1, 1.0 - wy1

    def gather(yy, xx):
        inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = (yy.clamp(0, h - 1).to(torch.int64) * w + xx.clamp(0, w - 1).to(torch.int64))
        vals = torch.gather(flat, 1, idx[..., None].expand(b, idx.shape[1], c))
        return torch.where(inb[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                             device=vals.device))

    return (gather(y0, x0) * (wy0 * wx0)[..., None]
            + gather(y0, x0 + 1) * (wy0 * wx1)[..., None]
            + gather(y0 + 1, x0) * (wy1 * wx0)[..., None]
            + gather(y0 + 1, x0 + 1) * (wy1 * wx1)[..., None])


def ms_deform_attn(value: torch.Tensor, value_spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """value [B, S, M, D] (S = sum of H*W over the levels), sampling_locations
    [B, Lq, M, L, P, 2] in [0, 1] (x, y), attention_weights [B, Lq, M, L, P]
    -> [B, Lq, M*D] in value's dtype."""
    b, _, m, d = value.shape
    _, lq, _, _, p, _ = sampling_locations.shape
    grids = 2 * sampling_locations - 1
    out = torch.zeros((b, lq, m, d), dtype=torch.float32, device=value.device)
    offset = 0
    for lid, (h, w) in enumerate(value_spatial_shapes):
        v = value[:, offset:offset + h * w]
        offset += h * w
        v = v.permute(0, 2, 1, 3).reshape(b * m, h, w, d)
        g = grids[:, :, :, lid].permute(0, 2, 1, 3, 4).reshape(b * m, lq * p, 2)
        x = (g[..., 0] + 1.0) * 0.5 * w - 0.5
        y = (g[..., 1] + 1.0) * 0.5 * h - 0.5
        sampled = _bilinear_zeros(v, x, y).reshape(b, m, lq, p, d)
        aw = attention_weights[:, :, :, lid].permute(0, 2, 1, 3)  # [B, M, Lq, P]
        out = out + torch.einsum("bmqpd,bmqp->bqmd", sampled.to(torch.float32),
                                 aw.to(torch.float32))
    return out.reshape(b, lq, m * d).to(value.dtype)
