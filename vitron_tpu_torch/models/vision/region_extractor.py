"""Region feature extractor: bbox -> mask-pooled patch features + location embed.

Port of `vitron_tpu/models/vision/region_extractor.py`, including the
reference's rasterization quirk `mask[int(x1):int(x2), int(y1):int(y2)] = 1`
(x indexes the FIRST mask axis): the trained weights saw that layout.
The mask is resized to the patch grid with a bilinear, half-pixel,
non-antialiased resize (what `jax.image.resize(..., "linear",
antialias=False)` computes), re-binarized, and used for a normalized
mask-pool; then a 3-layer ReLU MLP plus a 2-layer location encoder.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from vitron_tpu_torch.models.llm.llama import dense_init


def init_params(gen: torch.Generator, in_dim: int, out_dim: int, device,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    def dense(shape):
        return dense_init(gen, shape, dtype, device)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "mlp": {
            "w0": dense((in_dim, out_dim)), "b0": zeros(out_dim),
            "w1": dense((out_dim, out_dim)), "b1": zeros(out_dim),
            "w2": dense((out_dim, out_dim)), "b2": zeros(out_dim),
        },
        "loc": {
            "w0": dense((4, out_dim // 2)), "b0": zeros(out_dim // 2),
            "w1": dense((out_dim // 2, out_dim)), "b1": zeros(out_dim),
        },
    }


def rasterize_bbox_mask(bboxes: torch.Tensor, image_size: int) -> torch.Tensor:
    """[B, 4] (x1, y1, x2, y2) -> [B, image_size, image_size] float32 masks;
    int truncation of the coordinates, x indexes axis 0."""
    bb = torch.floor(bboxes).to(torch.int64)
    idx = torch.arange(image_size, device=bboxes.device)
    rows, cols = idx[None, :, None], idx[None, None, :]
    x1, y1, x2, y2 = (bb[:, i, None, None] for i in range(4))
    m = (rows >= x1) & (rows < x2) & (cols >= y1) & (cols < y2)
    return m.to(torch.float32)


def mask_pool(feats: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Normalized mask pooling. feats [B, N, C] (N = g*g grid), masks
    [B, S, S] -> [B, C]."""
    b, n, c = feats.shape
    g = int(round(n ** 0.5))
    small = F.interpolate(masks[:, None].to(torch.float32), size=(g, g), mode="bilinear",
                          align_corners=False, antialias=False)[:, 0]
    small = (small > 0).to(feats.dtype)
    denom = small.sum(dim=(-1, -2), keepdim=True) + 1e-8
    w = (small / denom).reshape(b, n)
    return torch.einsum("bnc,bn->bc", feats, w)


def apply(params: Dict[str, Any], feats: torch.Tensor, bboxes: torch.Tensor,
          image_size: int = 224) -> torch.Tensor:
    """feats [B, N, C] raw (pre-projector) patch features; bboxes [B, 4] in
    `image_size` coordinates -> [B, 1, out_dim]."""
    masks = rasterize_bbox_mask(bboxes, image_size).to(feats.dtype)
    pooled = mask_pool(feats, masks)
    m = params["mlp"]
    pooled = pooled.to(torch.promote_types(pooled.dtype, m["w0"].dtype))  # as jnp promotes
    x = torch.relu(pooled @ m["w0"] + m["b0"])
    x = torch.relu(x @ m["w1"] + m["b1"])
    x = x @ m["w2"] + m["b2"]
    loc_p = params["loc"]
    loc = torch.relu(bboxes.to(x.dtype) @ loc_p["w0"] + loc_p["b0"]) @ loc_p["w1"] + loc_p["b1"]
    return (x + loc)[:, None, :]


def convert_hf(state_dict, device="cpu") -> Dict[str, Any]:
    """Torch keys model.region_extractor.region_linear.layers.{0,1,2}.* and
    model.region_extractor.loc_encoder.loc_encoder.{0,2}.*
    -> the param dict on `device` (torch tensors as float32, numpy arrays in
    their type, as the JAX `convert_hf`)."""
    import numpy as np

    def g(k):
        v = state_dict["model.region_extractor." + k]
        v = torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v.detach().float()
        return v.to(device)

    def t(k):
        return g(k).t().contiguous()

    return {
        "mlp": {
            "w0": t("region_linear.layers.0.weight"), "b0": g("region_linear.layers.0.bias"),
            "w1": t("region_linear.layers.1.weight"), "b1": g("region_linear.layers.1.bias"),
            "w2": t("region_linear.layers.2.weight"), "b2": g("region_linear.layers.2.bias"),
        },
        "loc": {
            "w0": t("loc_encoder.loc_encoder.0.weight"), "b0": g("loc_encoder.loc_encoder.0.bias"),
            "w1": t("loc_encoder.loc_encoder.2.weight"), "b1": g("loc_encoder.loc_encoder.2.bias"),
        },
    }
