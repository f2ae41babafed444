"""Weight quantization: int8/int4 weight-only for the LLM, and the W4A8 /
W8A8 integer forms, in PyTorch.

Port of `vitron_tpu/kernels/quantization.py`. A quantized matrix is a dict
living at the weight's key: {"q": int8 [..., in, out], "s": f32 [..., 1, out]}
or, packed two nibbles per byte along the input dim, {"q4": int8
[..., in/2, out], "s"} (low nibble = even input row). The packing is
bit-identical to the JAX package, so converted checkpoints carry over.

`matmul_maybe_quantized` dispatches on the leaf's keys, as JAX's does:

- {"q4", "s"}: a 2-D weight goes through `kernels.int4_matmul.int4_matmul`
  (B1: the hand CUDA kernel for CUDA tensors, its plain version for CPU
  tensors); stacked (>= 3-D) leaves never reach it on the chat path (the
  layer loop indexes them first) and are dequantized plainly.
- {"qa8", "s"} (W4A8, made by `promote_int4(a8=True)` when VITRON_W4A8=1): a
  2-D weight goes through `kernels.w4a8_matmul.w4a8_matmul` (Q1): each row of
  x quantized to int8 by its absmax (or the VITRON_W4A8_STATIC scale, read
  when the tree is promoted and kept in the leaf as "sx"), an s8 x s4
  product with int32 sums, then `acc * sx * s`. Stacked leaves take the
  convert path, as in JAX. The port's "qa8" leaf keeps B1's packed nibbles
  [in/2, out] where JAX expands them to a native s4 array [in, out]: it is
  the port's own form, made and read only here, and never crosses to JAX.
  `promote_int4(a8=False)` leaves the packed {"q4"} leaves as they are: B1
  reads the packing directly, which is what JAX's native s4 form buys it.
- {"q8", "s"} (W8A8 dots, `quantize_int8_a8`): x quantized per row, an
  s8 x s8 product with int32 sums (`torch._int_mm` on the card, the integer
  form of the XLA dot; an int32 product on the CPU), `acc * sx * s`.

`conv2d_w8a8` (the {"qc", "s"} convs of `quantize_conv2d`) quantizes x per
tensor and runs Q2 (`kernels.conv2d_w8a8`); the {"q8t", "s"} temporal taps
of `quantize_tconv` are `kernels.temporal_conv`'s. Every scale divides by a
tensor (`_absmax_scale`): a CUDA tensor divided by a Python number is
multiplied by its rounded reciprocal, which differs from JAX's division in
the last bit. Rounding is half to even, as `jnp.round`, and the clamp is at
+-127. The integer forms are inference-only, as in JAX.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Union

import torch

from vitron_tpu_torch.kernels.conv2d_w8a8 import conv_s8
from vitron_tpu_torch.kernels.int4_matmul import int4_matmul, unpack_int4
from vitron_tpu_torch.kernels.w4a8_matmul import quantize_rows, w4a8_matmul

Weight = Union[torch.Tensor, Dict[str, torch.Tensor]]

_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def _absmax_scale(w32: torch.Tensor, qmax: float, dim=-2, keepdim: bool = True) -> torch.Tensor:
    """max(|w| over `dim`, 1e-8) / qmax, divided exactly: a CUDA tensor
    divided by a Python number is multiplied by its rounded reciprocal,
    which differs from JAX's division in the last bit."""
    amax = w32.abs().amax(dim=dim, keepdim=keepdim)
    return torch.clamp(amax, min=1e-8) / torch.full_like(amax, qmax)


def _q8(w32: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)


def quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8: w ~= q * s. w: [..., in, out]."""
    w32 = w.to(torch.float32)
    s = _absmax_scale(w32, 127.0)
    return {"q": _q8(w32, s), "s": s}


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


def quantize_int8_a8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 weight of a W8A8 dot ("q8"): the
    activation is quantized too, per row, at every call."""
    q = quantize_int8(w)
    return {"q8": q["q"], "s": q["s"]}


def quantize_tconv(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 of the k=3 temporal conv taps
    ("q8t"): w [3, C, Co] or the torch layout [3, 1, C, Co] -> q8t [3, C, Co],
    s [Co]."""
    if w.dim() == 4:
        w = w[:, 0]
    w32 = w.to(torch.float32)
    s = _absmax_scale(w32, 127.0, dim=(0, 1), keepdim=False)
    return {"q8t": _q8(w32, s), "s": s}


def quantize_conv2d(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel int8 of a conv weight [kh, kw, ci, co]
    ("qc", so `matmul_maybe_quantized` never takes a conv weight):
    `layers.conv2d` dispatches on it."""
    w32 = w.to(torch.float32)
    s = _absmax_scale(w32, 127.0, dim=(0, 1, 2), keepdim=False)
    return {"qc": _q8(w32, s), "s": s}


def w4a8_default() -> bool:
    """The W4A8 decode knob: VITRON_W4A8=1 opts in (default off). Read when
    a program's tree is promoted (`promote_int4`), not per call."""
    return os.environ.get("VITRON_W4A8", "0") == "1"


def promote_int4(tree, a8: Optional[bool] = None):
    """With a8 (None: `w4a8_default()`), every packed int4 leaf {"q4", "s",
    ...} becomes the W4A8 form {"qa8", "s", ...} on the same packed tensor
    (and "sx", the VITRON_W4A8_STATIC scale in float32, when that is set),
    so its products run Q1. Without, the tree is returned as it
    is: B1 reads the packing directly (JAX's a8=False expands it to native
    s4 for its dot). The dicts are new, the tensors shared."""
    if a8 is None:
        a8 = w4a8_default()
    if not a8:
        return tree
    static = os.environ.get("VITRON_W4A8_STATIC")

    def promote(p):
        if isinstance(p, dict):
            if "q4" in p:
                out = {**{k: v for k, v in p.items() if k != "q4"}, "qa8": p["q4"]}
                if static:  # one scale a matrix, [..., 1, 1] as the stacked leaves index
                    out["sx"] = torch.full(p["s"].shape[:-2] + (1, 1), float(static),
                                           dtype=torch.float32, device=p["q4"].device)
                return out
            return {k: promote(v) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(promote(v) for v in p)
        return p

    return promote(tree)


def dequantize(w: Weight) -> torch.Tensor:
    if isinstance(w, dict):
        if "q4" in w:
            return unpack_int4(w["q4"]).to(torch.float32) * w["s"]
        if "qa8" in w:
            return unpack_int4(w["qa8"]).to(torch.float32) * w["s"]
        for key in ("q8", "qc"):
            if key in w:
                return w[key].to(torch.float32) * w["s"]
        return w["q"].to(torch.float32) * w["s"]
    return w


def int_dot(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 xq [M, K] @ int8 q [K, N] -> int32 [M, N]: the XLA integer dot.
    `torch._int_mm` on CUDA tensors (M padded to its minimum of 17 rows and
    the padding sliced off; q handed over column-major, the layout cuBLASLt
    takes for the int8 product), an int32 product on the CPU."""
    if xq.device.type == "cpu":
        return xq.to(torch.int32) @ q.to(torch.int32)
    m = xq.shape[0]
    if m < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - m, xq.shape[1]))])
    return torch._int_mm(xq.contiguous(), q.t().contiguous().t())[:m]


def _w4a8_matmul(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    lead = x.shape[:-1]
    y = w4a8_matmul(x.reshape(-1, x.shape[-1]), w["qa8"], w["s"].to(torch.float32),
                    w.get("sx"))
    return y.reshape(*lead, y.shape[-1])


def _w8a8_matmul(x: torch.Tensor, w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per-row int8 activation, s8 x s8 -> s32, `acc * sx * s`."""
    lead = x.shape[:-1]
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = int_dot(xq, w["q8"])
    y = (acc.to(torch.float32) * sx * w["s"].to(torch.float32)).to(x.dtype)
    return y.reshape(*lead, y.shape[-1])


def conv2d_w8a8(x: torch.Tensor, w: Dict[str, torch.Tensor], stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """x [B, H, W, C] with {"qc" [3, 3, C, Co], "s" [Co]}: x quantized per
    tensor (plain torch ops, which XLA fused), Q2's int32 sums, then
    `y * (s * sx)` in float32 (JAX's association), cast to x.dtype."""
    x32 = x.to(torch.float32)
    sx = _absmax_scale(x32, 127.0, dim=tuple(range(x32.dim())), keepdim=False)
    return conv_s8(_q8(x32, sx), w["qc"], w["s"].to(torch.float32) * sx, stride, padding,
                   x.dtype)


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
        if "q8" in w:
            return _w8a8_matmul(x, w)
        if "qa8" in w:
            if w["qa8"].dim() == 2:
                return _w4a8_matmul(x, w)
            return _quantized_dot(x, unpack_int4(w["qa8"]), w["s"])  # stacked: convert path
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
