"""LoRA for the stacked-layer Llama (and the projector/region flags).

Port of `vitron_tpu/train/lora.py`, the reference PEFT setup (reference:
vitron/train/train.py:181-196,1102-1118; recipe r=128, alpha=256,
finetune_lora.sh:11): LoRA targets every LLM linear projection and never
the multimodal projector, the towers or the region extractor, which are
trained whole or frozen by flags (train.py:1185-1212).

Factors are stacked like the layers ([L, in, r] and [L, r, out]). `merge`
is functional: a dense base gets W + (A @ B) * alpha/r, and a quantized
base ({"q4","s"} or {"q","s"}) keeps its packed weights and carries the
factors as a low-rank bypass evaluated at matmul time
(`kernels.quantization.matmul_maybe_quantized`), so a frozen int4 base
trains with bf16 adapters (QLoRA).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

LORA_TARGETS = ("wq", "wk", "wv", "wo", "gate", "up", "down")
HF_NAMES = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj", "wv": "self_attn.v_proj",
            "wo": "self_attn.o_proj", "gate": "mlp.gate_proj", "up": "mlp.up_proj",
            "down": "mlp.down_proj"}


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 128
    alpha: int = 256
    targets: Tuple[str, ...] = LORA_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def init_lora_params(gen: torch.Generator, llm_params: Dict[str, Any],
                     cfg: LoraConfig) -> Dict[str, Any]:
    """A ~ N(0, 1/in), B = 0, so the model starts at its base. `gen` lives
    on the weights' device; the targets draw from it in `cfg.targets` order.
    A quantized base gets bfloat16 factors, a dense one its own dtype."""
    out = {}
    layers = llm_params["layers"]
    for name in cfg.targets:
        if name not in layers:
            continue
        w = layers[name]
        if isinstance(w, dict):
            q = w["q4"] if "q4" in w else w["q"]
            l, din, dout = q.shape
            if "q4" in w:
                din *= 2  # two nibbles packed per byte along the input dim
            dtype, device = torch.bfloat16, q.device
        else:
            (l, din, dout), dtype, device = w.shape, w.dtype, w.device
        a = torch.randn((l, din, cfg.r), generator=gen, dtype=torch.float32, device=device)
        out[name] = {"a": (a / din ** 0.5).to(dtype),
                     "b": torch.zeros((l, cfg.r, dout), dtype=dtype, device=device)}
    return out


def merge(llm_params: Dict[str, Any], lora_params: Dict[str, Any],
          cfg: LoraConfig) -> Dict[str, Any]:
    """Params with W + (A @ B) * scaling, differentiable in the factors; a
    quantized base keeps its packed weights and gains "lora_a", "lora_b"
    and "lora_scale" [L, 1, 1] (the bypass)."""
    layers = dict(llm_params["layers"])
    for name, ab in lora_params.items():
        w = layers[name]
        if isinstance(w, dict):
            scale = torch.full((ab["a"].shape[0], 1, 1), cfg.scaling, dtype=torch.float32,
                               device=ab["a"].device)
            layers[name] = {**w, "lora_a": ab["a"], "lora_b": ab["b"], "lora_scale": scale}
            continue
        delta = torch.einsum("lir,lro->lio", ab["a"].to(torch.float32),
                             ab["b"].to(torch.float32)) * cfg.scaling
        layers[name] = (w.to(torch.float32) + delta).to(w.dtype)
    return {**llm_params, "layers": layers}


def export_hf_lora(lora_params: Dict[str, Any], cfg: LoraConfig) -> Dict[str, np.ndarray]:
    """Stacked factors -> a peft-style flat float32 state dict, per layer and
    in torch's [out, in] layout, for the reference loader."""
    out = {}
    for name, ab in lora_params.items():
        a = ab["a"].detach().to(torch.float32).cpu().numpy()  # [L, in, r]
        b = ab["b"].detach().to(torch.float32).cpu().numpy()  # [L, r, out]
        for i in range(a.shape[0]):
            stem = f"base_model.model.model.layers.{i}.{HF_NAMES[name]}"
            out[f"{stem}.lora_A.weight"] = np.ascontiguousarray(a[i].T)  # [r, in]
            out[f"{stem}.lora_B.weight"] = np.ascontiguousarray(b[i].T)  # [out, r]
    return out


def trainable_filter(tune_projector: bool = True, tune_region: bool = True,
                     tune_lora: bool = True, tune_base: bool = False):
    """Path-based trainability (train.py:1185-1212): the towers always
    frozen; projector, region and LoRA selectable. -> f(path tuple) -> bool."""

    def f(path: Tuple[str, ...]) -> bool:
        joined = "/".join(str(p) for p in path)
        if "image_tower" in joined or "video_tower" in joined:
            return False
        if joined.startswith("lora"):
            return tune_lora
        if "projector" in joined:
            return tune_projector
        if "region" in joined:
            return tune_region
        return tune_base

    return f
