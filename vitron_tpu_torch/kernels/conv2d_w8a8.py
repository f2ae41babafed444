"""Q2, the W8A8 3x3 convolution: the hand CUDA kernel and its plain twin.

Replaces no Pallas kernel: the JAX package computes it in XLA
(`vitron_tpu/kernels/quantization.py::conv2d_w8a8` :277, a
`conv_general_dilated` of s8 x s8 with int32 sums), and PyTorch has no int8
convolution on CUDA.

    xq [B, H, W, C] int8 (NHWC), qc [3, 3, C, Co] int8 (HWIO), ssx [Co] float32
    conv_s8(xq, qc, ssx, stride, padding, dtype) = float32(conv(xq, qc)) * ssx

at stride 1 or 2 and padding 0 or 1, cast to `dtype`. The caller
(`quantization.conv2d_w8a8`) quantizes the activation per tensor with plain
torch ops and passes ssx = s * sx, JAX's association. The kernel is
`csrc/conv2d_w8a8.cu`, an implicit GEMM on mma.sync s8 with int32 sums (its
note says what bounds it). The plain version is one exact form for both
devices: a float64 `F.conv2d` of the integer values, whose sums (below
127^2 9 C < 2^53) are exact, rounded to float32 as the int32 sums are.
`conv_s8` launches the kernel for CUDA tensors and takes the plain version
only for CPU tensors; `launches` counts kernel launches. Inference only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)


def out_size(h: int, stride: int, padding: int) -> int:
    return (h + 2 * padding - 3) // stride + 1


def conv_sums_plain(xq: torch.Tensor, qc: torch.Tensor, stride: int,
                    padding: int) -> torch.Tensor:
    """The exact integer sums [B, OH, OW, Co] as float64, on any device."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).to(torch.float64),
                   qc.permute(3, 2, 0, 1).to(torch.float64), stride=stride, padding=padding)
    return acc.permute(0, 2, 3, 1)


def conv_s8_plain(xq: torch.Tensor, qc: torch.Tensor, ssx: torch.Tensor, stride: int,
                  padding: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version on any device: the exact sums rounded to
    float32 (as an int32 sum converts), times ssx, cast to `dtype`."""
    acc = conv_sums_plain(xq, qc, stride, padding)
    return (acc.to(torch.float32) * ssx.to(torch.float32)).to(dtype)


def conv_s8(xq: torch.Tensor, qc: torch.Tensor, ssx: torch.Tensor, stride: int, padding: int,
            dtype: torch.dtype) -> torch.Tensor:
    """[B, OH, OW, Co] in `dtype` (float32 or bfloat16 on the card)."""
    global launches
    if xq.dim() != 4 or tuple(qc.shape[:2]) != (3, 3) or qc.dim() != 4 \
            or qc.shape[2] != xq.shape[3]:
        raise ValueError(f"conv2d_w8a8: xq {tuple(xq.shape)} and qc {tuple(qc.shape)} must be "
                         "[B, H, W, C] and [3, 3, C, Co]")
    b, h, w, c = xq.shape
    co = qc.shape[3]
    if tuple(ssx.shape) != (co,):
        raise ValueError(f"conv2d_w8a8: scale shape {tuple(ssx.shape)} != ({co},)")
    if stride not in (1, 2) or padding not in (0, 1):
        raise NotImplementedError(f"conv2d_w8a8: stride {stride}, padding {padding} (stride 1 "
                                  "or 2, padding 0 or 1)")
    tensors = (xq, qc, ssx)
    if all(t.device.type == "cpu" for t in tensors):
        return conv_s8_plain(xq, qc, ssx, stride, padding, dtype)
    if any(t.device.type != "cuda" or t.device != xq.device for t in tensors):
        raise ValueError("conv2d_w8a8: xq, qc and the scale must share one CUDA device")
    if xq.dtype != torch.int8 or qc.dtype != torch.int8 or ssx.dtype != torch.float32:
        raise TypeError("conv2d_w8a8: xq and qc must be int8 and the scale float32")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv2d_w8a8: output dtype {dtype} is not float32/bfloat16")
    if c % 16 or co % 4:
        raise NotImplementedError(f"conv2d_w8a8: no CUDA kernel for C={c}, Co={co} (C a "
                                  "multiple of 16, Co of 4)")
    oh, ow = out_size(h, stride, padding), out_size(w, stride, padding)
    xq, qc, ssx = _build.aligned16(xq), _build.aligned16(qc), ssx.contiguous()
    y = torch.empty((b, oh, ow, co), dtype=dtype, device=xq.device)
    if y.numel():
        rc = _build.lib().vt_conv2d_w8a8(
            xq.data_ptr(), qc.data_ptr(), ssx.data_ptr(), y.data_ptr(), b, h, w, c, co, stride,
            padding, int(dtype == torch.bfloat16), _build.stream_handle(xq.device))
        _build.check(rc, "conv2d_w8a8")
        launches += 1
    return y
