"""Weight-only int8/int4 quantization for the LLM, in PyTorch.

Port of `vitron_tpu/kernels/quantization.py`. A quantized matrix is a dict
living at the weight's key: {"q": int8 [..., in, out], "s": f32 [..., 1, out]}
or, packed two nibbles per byte along the input dim, {"q4": int8
[..., in/2, out], "s"} (low nibble = even input row). The packing is
bit-identical to the JAX package, so converted checkpoints carry over.

`matmul_maybe_quantized` dispatches on the leaf's type. A 2-D int4 weight
goes through `kernels.int4_matmul.int4_matmul`: the hand CUDA kernel for
CUDA tensors, its plain version for CPU tensors. Stacked (>= 3-D) int4
leaves never reach it on the chat path (the layer loop indexes them first)
and are dequantized plainly. The W4A8 ("qa8") and W8A8 ("q8") forms are not
ported yet (ROADMAP A17).
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from vitron_tpu_torch.kernels.int4_matmul import int4_matmul, unpack_int4

Weight = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _absmax_scale(w32: torch.Tensor, qmax: float) -> torch.Tensor:
    """max(|w| over the input dim, 1e-8) / qmax, divided exactly: a CUDA
    tensor divided by a Python number is multiplied by its rounded
    reciprocal, which differs from JAX's division in the last bit."""
    amax = w32.abs().amax(dim=-2, keepdim=True)
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, qmax)


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: w ~= q * s. w: [..., in, out]."""
    w32 = w.to(torch.float32)
    s = _absmax_scale(w32, 127.0)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int4, two values packed per byte along
    the input dim (in must be even)."""
    w32 = w.to(torch.float32)
    s = _absmax_scale(w32, 7.0)
    q = torch.clamp(torch.round(w32 / s), -7, 7).to(torch.int16)
    lo = q[..., 0::2, :] & 0xF
    hi = q[..., 1::2, :] & 0xF
    packed = ((hi << 4) | lo).to(torch.uint8).view(torch.int8)
    return {"q4": packed, "s": s}


def dequantize(w: Weight) -> torch.Tensor:
    if isinstance(w, dict):
        if "q4" in w:
            return unpack_int4(w["q4"]).to(torch.float32) * w["s"]
        return w["q"].to(torch.float32) * w["s"]
    return w


def _quantized_dot(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    y = x @ q.to(x.dtype)
    return y * s.to(y.dtype)


def matmul_maybe_quantized(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x @ w for plain tensors or quantized dicts; the scale applies after the
    product (per output channel).

    A quantized dict may carry LoRA bypass factors ("lora_a" [in, r],
    "lora_b" [r, out], "lora_scale"): y = x@W_q + (x@A)@B * scale."""
    if isinstance(w, dict) and "lora_a" in w:
        base = {k: v for k, v in w.items() if not k.startswith("lora_")}
        bypass = ((x.to(torch.float32) @ w["lora_a"].to(torch.float32))
                  @ w["lora_b"].to(torch.float32)) * w["lora_scale"]
        y = matmul_maybe_quantized(x, base)
        return y + bypass.to(y.dtype)
    if isinstance(w, dict):
        if "q8" in w or "qa8" in w:
            raise NotImplementedError(
                "W8A8/W4A8 weights ('q8'/'qa8') are not ported yet (ROADMAP A17)")
        if "q4" in w:
            q4 = w["q4"]
            if q4.dim() == 2:
                lead = x.shape[:-1]
                y = int4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), q4,
                                w["s"].to(torch.float32))
                return y.reshape(*lead, y.shape[-1])
            return _quantized_dot(x, unpack_int4(q4), w["s"])
        return _quantized_dot(x, w["q"], w["s"])
    return x @ w


LLAMA_PROJECTIONS = ("wq", "wk", "wv", "wo", "gate", "up", "down")


def quantize_llama(params: Dict[str, Any], bits: int = 8, head: bool = False) -> Dict[str, Any]:
    """Quantize the projection matrices of a llama param dict (embed and
    norms stay as they are); head=True also quantizes lm_head."""
    fn = quantize_int8 if bits == 8 else quantize_int4
    layers = dict(params["layers"])
    for t in LLAMA_PROJECTIONS:
        layers[t] = fn(layers[t])
    out = {**params, "layers": layers}
    if head and "lm_head" in out:
        out["lm_head"] = fn(out["lm_head"])
    return out
