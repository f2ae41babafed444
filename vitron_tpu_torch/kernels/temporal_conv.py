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
only for CPU tensors. `launches` counts kernel launches. Only the forward is
ported: the JAX custom VJP (dx by the frame-flipped transposed taps, dw by
einsums, :158-171) comes with training, and the W8A8 `{"q8t", "s"}` weights
with the quantized variants.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)


def _taps(w: torch.Tensor) -> torch.Tensor:
    """[3, C, Co] or [3, 1, C, Co] -> [3, C, Co]."""
    if isinstance(w, dict):
        raise NotImplementedError("quantized temporal-conv weights (W8A8) are not ported yet "
                                  "(ROADMAP A17)")
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


def temporal_conv_k3(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, F, ..., C] -> [B, F, ..., Co]: the frame-axis k=3 SAME conv."""
    global launches
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
    if all(t.device.type == "cpu" for t in tensors):
        return temporal_conv_k3_plain(x4, w, bias).reshape(shape[:-1] + (co,))
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("temporal_conv_k3: x, w and bias must share one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x.dtype
                                                              for t in tensors):
        raise TypeError(f"temporal_conv_k3: x, w and bias must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if c % 8 or co % 8:
        raise NotImplementedError(f"temporal_conv_k3: no CUDA kernel for C={c}, Co={co} (C and "
                                  "Co multiples of 8)")
    x4, w = _build.aligned16(x4), _build.aligned16(w)
    if bias is not None:
        bias = bias.contiguous()
    y = torch.empty((b, f, n, co), dtype=x.dtype, device=x.device)
    if y.numel():
        rc = _build.lib().vt_temporal_conv_k3(
            x4.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
            y.data_ptr(), b, f, n, c, co, int(x.dtype == torch.bfloat16),
            _build.stream_handle(x.device))
        _build.check(rc, "temporal_conv_k3")
        launches += 1
    return y.reshape(shape[:-1] + (co,))

