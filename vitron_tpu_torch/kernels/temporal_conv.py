"""Temporal (frame-axis) k=3 convolution: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/temporal_conv.py::_kernel`
(:44, pallas_call at :81 in `_tconv_pallas` :56, entry `temporal_conv_k3`
:177):

    x [B, F, ..., C], w [3, C, Co] (or the torch layout [3, 1, C, Co]), bias [Co]
    y[:, f] = sum_{d=0..2} x[:, f + d - 1] @ w[d] (+ bias), zero frames outside

with float32 sums and y in x's dtype; the middle dims are flattened to
[B, F, N, C] for the kernel and restored. The video UNets run it four times
at the end of every res block (`video_unet.temporal_conv_block`).

The kernel is `csrc/temporal_conv.cu`: one tiled GEMM of B * F * N rows and
depth 3C whose tile loader reads the three frame-shifted rows of x in place,
so the taps meet in float32 registers and y is written once, the bias added
before its one rounding (the JAX entry adds it after the cast; the
tolerances cover that rounding). On the TPU the kernel sat behind
`VITRON_TCONV=pallas` because XLA fused the shifted partials into its dot
epilogues; PyTorch has no such fusion, so every CUDA call launches this
kernel. x, w and the bias are float32 or bfloat16, all of one dtype.
`temporal_conv_k3` launches it for CUDA tensors and takes the plain version
only for CPU tensors. When a gradient is wanted (grad mode on and x, w or
the bias requiring grad) it goes through `TemporalConvK3`, the port of the
JAX `custom_vjp` (`_tconv_bwd` :158-171): dx is the same conv (the kernel on
the card, one more launch) of the cotangent with the frame-flipped,
transposed taps, dw three float32 einsums, and the bias gradient the sum of
the cotangent. `launches` counts kernel launches.

The W8A8 taps (`quantization.quantize_tconv`'s {"q8t": int8 [3, C, Co],
"s": [Co]}) take `_tconv_w8a8`, JAX's form (:109): x quantized once per row,
three int8 tap products with int32 sums (`quantization.int_dot`, the XLA
dot: `torch._int_mm` on the card), each scaled and cast to x's dtype, then
shifted by a frame and added. Serving only, as in JAX.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from vitron_tpu_torch.kernels import _build, quantization
from vitron_tpu_torch.kernels.w4a8_matmul import quantize_rows

launches = 0  # kernel launches since the last reset (CPU calls do not count)


def _taps(w: torch.Tensor) -> torch.Tensor:
    """[3, C, Co] or [3, 1, C, Co] -> [3, C, Co]."""
    if w.dim() == 4:
        if w.shape[1] != 1:
            raise ValueError(f"temporal_conv_k3: torch-layout taps must be [3, 1, C, Co], got "
                             f"{tuple(w.shape)}")
        w = w[:, 0]
    if w.dim() != 3 or w.shape[0] != 3:
        raise ValueError(f"temporal_conv_k3: taps must be [3, C, Co], got {tuple(w.shape)}")
    return w


def temporal_conv_k3_plain(x4: torch.Tensor, w: torch.Tensor,
                           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version on x4 [B, F, N, C], w [3, C, Co]: the JAX
    shift-matmul form `_tconv_xla` (:136-143), summed in float32, the bias
    added before the cast to x's dtype, as the kernel does."""
    f32 = torch.float32
    x32, w32 = x4.to(f32), w.to(f32)
    y = x32 @ w32[1]
    y[:, 1:] += (x32 @ w32[0])[:, :-1]
    y[:, :-1] += (x32 @ w32[2])[:, 1:]
    if bias is not None:
        y = y + bias.to(f32)
    return y.to(x4.dtype)


def _tconv_bwd(x4: torch.Tensor, w: torch.Tensor, g: torch.Tensor, needs=(True, True)):
    """The JAX `_tconv_bwd` at the cotangent g [B, F, N, Co]: dx = the conv
    of g with flip(w, 0) transposed to [3, Co, C] (the kernel on CUDA
    tensors), dw[d] = sum over (b, f, n) of x[f]^T g[f + 1 - d] in float32.
    -> (dx, dw), None where `needs` is false."""
    dx = dw = None
    if needs[0]:
        wt = torch.flip(w, (0,)).transpose(1, 2).contiguous().to(g.dtype)
        dx = _conv(g, wt, None).to(x4.dtype)
    if needs[1]:
        f = x4.shape[1]
        gp = torch.nn.functional.pad(g.to(torch.float32), (0, 0, 0, 0, 1, 1))
        x32 = x4.to(torch.float32)
        dw = torch.stack([torch.einsum("bfnc,bfnd->cd", x32, gp[:, 2 - d:2 - d + f])
                          for d in range(3)]).to(w.dtype)
    return dx, dw


class TemporalConvK3(torch.autograd.Function):
    """temporal_conv_k3 on x4 [B, F, N, C] with gradients for x, the taps
    [3, C, Co] and the bias."""

    @staticmethod
    def forward(ctx, x4, w, bias):
        ctx.save_for_backward(x4, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return _conv(x4, w, bias)

    @staticmethod
    def backward(ctx, g):
        x4, w = ctx.saved_tensors
        g = g.contiguous()
        dx, dw = _tconv_bwd(x4, w, g, ctx.needs_input_grad[:2])
        db = (g.to(torch.float32).sum((0, 1, 2)).to(ctx.bias_dtype)
              if ctx.needs_input_grad[2] else None)
        return dx, dw, db


def _tconv_w8a8(x4: torch.Tensor, w) -> torch.Tensor:
    """x4 [B, F, N, C] with the {"q8t", "s"} taps -> [B, F, N, Co] in x's dtype."""
    b, f, n, c = x4.shape
    xq, sx = quantize_rows(x4.reshape(-1, c))
    sw = w["s"].to(torch.float32)

    def tap(d):
        acc = quantization.int_dot(xq, w["q8t"][d])
        return (acc.to(torch.float32) * sx * sw).to(x4.dtype).reshape(b, f, n, -1)

    y = tap(1)
    y0 = torch.nn.functional.pad(tap(0)[:, :-1], (0, 0, 0, 0, 1, 0))
    y2 = torch.nn.functional.pad(tap(2)[:, 1:], (0, 0, 0, 0, 0, 1))
    return y + y0 + y2


def temporal_conv_k3(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, F, ..., C] -> [B, F, ..., Co]: the frame-axis k=3 SAME conv."""
    if isinstance(w, dict):
        shape = x.shape
        n = math.prod(shape[2:-1])
        out = _tconv_w8a8(x.reshape(shape[0], shape[1], n, shape[-1]), w)
        out = out.reshape(shape[:-1] + (out.shape[-1],))
        return out if bias is None else out + bias.to(out.dtype)
    w = _taps(w)
    shape = x.shape
    if x.dim() < 3 or w.shape[1] != shape[-1]:
        raise ValueError(f"temporal_conv_k3: x [B, F, ..., C] and w [3, C, Co] do not match: "
                         f"{tuple(shape)}, {tuple(w.shape)}")
    b, f, c, co = shape[0], shape[1], shape[-1], w.shape[-1]
    n = math.prod(shape[2:-1])
    if bias is not None and tuple(bias.shape) != (co,):
        raise ValueError(f"temporal_conv_k3: bias must be [{co}], got {tuple(bias.shape)}")
    tensors = [t for t in (x, w, bias) if t is not None]
    x4 = x.reshape(b, f, n, c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        y = TemporalConvK3.apply(x4, w, bias)
    else:
        y = _conv(x4, w, bias)
    return y.reshape(shape[:-1] + (co,))


def _conv(x4: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    """x4 [B, F, N, C], w [3, C, Co] -> [B, F, N, Co]: the plain version for
    CPU tensors, else the kernel."""
    global launches
    b, f, n, c = x4.shape
    co = w.shape[-1]
    tensors = [t for t in (x4, w, bias) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return temporal_conv_k3_plain(x4, w, bias)
    if any(t.device.type != "cuda" or t.device != x4.device for t in tensors):
        raise ValueError("temporal_conv_k3: x, w and bias must share one CUDA device")
    if x4.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x4.dtype
                                                              for t in tensors):
        raise TypeError(f"temporal_conv_k3: x, w and bias must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if c % 8 or co % 8:
        raise NotImplementedError(f"temporal_conv_k3: no CUDA kernel for C={c}, Co={co} (C and "
                                  "Co multiples of 8)")
    x4, w = _build.aligned16(x4), _build.aligned16(w)
    if bias is not None:
        bias = bias.contiguous()
    y = torch.empty((b, f, n, co), dtype=x4.dtype, device=x4.device)
    if y.numel():
        rc = _build.lib().vt_temporal_conv_k3(
            x4.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
            y.data_ptr(), b, f, n, c, co, int(x4.dtype == torch.bfloat16),
            _build.stream_handle(x4.device))
        _build.check(rc, "temporal_conv_k3")
        launches += 1
    return y

