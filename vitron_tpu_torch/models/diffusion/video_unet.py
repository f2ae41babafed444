"""The video UNets' temporal convolution block.

Port of `vitron_tpu/models/diffusion/video_unet.py::temporal_conv_block`
(:69-99), the TemporalConvBlock_v2 that ends every res block of the served
video UNets (`unet_sd_video._res_block`): four times (group norm with torch's
default eps 1e-5 and statistics over (F, H, W) -> SiLU -> frame-axis k=3
conv), then the identity added back. The conv is
`kernels.temporal_conv.temporal_conv_k3` (B6) on CUDA tensors.

The rest of that file (`VideoUNetConfig`, `forward`,
`temporal_attention_block`: the SD-UNet-based video model) is on no served
path: only the JAX package's own tests call it, so it is not ported
(ROADMAP A11).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels.temporal_conv import temporal_conv_k3
from vitron_tpu_torch.models.diffusion.layers import group_norm


def temporal_conv_block(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """x [B, F, H, W, C] -> the same shape: 4 x (GN -> SiLU -> k=3 conv over
    F) with an identity residual; taps [3, 1, C, C] (the torch layout) or
    [3, C, C], cast to x's dtype."""
    identity = x
    for i in range(4):
        x = group_norm(x, p[f"norm{i}_s"], p[f"norm{i}_b"], eps=1e-5)
        x = F.silu(x)
        x = temporal_conv_k3(x, p[f"conv{i}_w"].to(x.dtype), p[f"conv{i}_b"].to(x.dtype))
    return identity + x
