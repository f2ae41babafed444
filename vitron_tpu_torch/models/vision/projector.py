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
    """x takes the weights' type where that is wider (a loaded float32
    projector on a bf16 tower's features), as jnp's promotion does."""
    if not params:
        return x
    w = params["w"] if "w" in params else params["w1"]
    x = x.to(torch.promote_types(x.dtype, w.dtype))
    if "w" in params:
        return x @ params["w"] + params["b"]
    h = F.gelu(x @ params["w1"] + params["b1"], approximate="none")
    return h @ params["w2"] + params["b2"]


def convert_hf(state_dict, device="cpu") -> Dict[str, Any]:
    """HF keys model.mm_projector.{0,2}.{weight,bias} (mlp2x_gelu's
    Sequential) or model.mm_projector.{weight,bias} (linear) -> the param dict on
    `device`. Torch tensors become float32, numpy arrays keep their type
    (the JAX `convert_hf`)."""
    import numpy as np

    def g(k):
        v = state_dict["model.mm_projector." + k]
        v = torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray) else v.detach().float()
        return v.to(device)

    if "model.mm_projector.2.weight" in state_dict:
        return {"w1": g("0.weight").t().contiguous(), "b1": g("0.bias"),
                "w2": g("2.weight").t().contiguous(), "b2": g("2.bias")}
    return {"w": g("weight").t().contiguous(), "b": g("bias")}
