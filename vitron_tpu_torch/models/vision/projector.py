"""Vision -> LM projector (port of `vitron_tpu/models/vision/projector.py`).

The trained config is `mlp2x_gelu` (Linear 1024->4096, exact-erf GELU,
Linear 4096->4096); `linear` and `identity` are implied by the param keys.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from vitron_tpu_torch.models.llm.llama import dense_init


def init_params(gen: torch.Generator, in_dim: int, out_dim: int, device,
                projector_type: str = "mlp2x_gelu",
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    if projector_type == "identity":
        return {}
    if projector_type == "linear":
        return {"w": dense_init(gen, (in_dim, out_dim), dtype, device),
                "b": torch.zeros((out_dim,), dtype=dtype, device=device)}
    if projector_type == "mlp2x_gelu":
        return {
            "w1": dense_init(gen, (in_dim, out_dim), dtype, device),
            "b1": torch.zeros((out_dim,), dtype=dtype, device=device),
            "w2": dense_init(gen, (out_dim, out_dim), dtype, device),
            "b2": torch.zeros((out_dim,), dtype=dtype, device=device),
        }
    raise ValueError(f"unknown projector type {projector_type}")


def apply(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    if not params:
        return x
    if "w" in params:
        return x @ params["w"] + params["b"]
    h = F.gelu(x @ params["w1"] + params["b1"], approximate="none")
    return h @ params["w2"] + params["b2"]
