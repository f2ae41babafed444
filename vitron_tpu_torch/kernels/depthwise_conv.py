"""Depthwise 2D convolution: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/depthwise_conv.py::_kernel`
(:35, pallas_call at :66 in `_dw_pallas` :54, entry `depthwise_conv2d` :138):

    x [B, H, W, C] (NHWC), w [k, k, C] (or [k, k, 1, C] HWIO), k odd
    y[b, h, w, c] = sum_{dy, dx} xpad[b, h + dy, w + dx, c] * w[dy, dx, c]

stride 1, SAME zero padding, float32 products and sums, y in x's dtype; the
bias is added after the kernel, as the JAX entry adds it. FocalNet's focal
levels (k = 3/5/7/9) call it.

The kernel is `csrc/depthwise_conv.cu` (k in {3, 5, 7, 9}, x and w both
float32 or both bfloat16). `depthwise_conv2d` launches it
for CUDA tensors and takes the plain version only for CPU tensors; other k
or dtypes on the card raise. `launches` counts kernel launches. Only the
forward is ported: the JAX kernel's custom VJP (dx by the flipped filter, dw
by a reduction, :108-135) comes with training.
"""
from __future__ import annotations

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

KERNEL_SIZES = (3, 5, 7, 9)
_LANES = 32          # channels per block (csrc kLanes)
_STRIP = 8           # output columns per thread step (csrc kStrip)
_WANT_BLOCKS = 264   # two blocks for each of the H100's 132 SMs


def _taps(w: torch.Tensor) -> torch.Tensor:
    """[k, k, C] or HWIO [k, k, 1, C] -> [k, k, C]; raises on even or
    non-square k."""
    if w.dim() == 4:
        if w.shape[2] != 1:
            raise ValueError(f"depthwise_conv2d: HWIO weights need one input channel per "
                             f"group, got {tuple(w.shape)}")
        w = w[:, :, 0, :]
    if w.dim() != 3 or w.shape[0] != w.shape[1] or w.shape[0] % 2 != 1:
        raise ValueError(f"depthwise_conv2d: odd square kernel required, got {tuple(w.shape)}")
    return w


def depthwise_conv2d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the JAX `reference` shift-and-add (:95-105),
    accumulated in float32 in the same tap order, cast to x's dtype."""
    w = _taps(w)
    k = w.shape[0]
    p = k // 2
    b, h, wd, c = x.shape
    xp = torch.nn.functional.pad(x.to(torch.float32), (0, 0, p, p, p, p))
    w32 = w.to(torch.float32)
    acc = torch.zeros((b, h, wd, c), dtype=torch.float32, device=x.device)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[:, dy:dy + h, dx:dx + wd] * w32[dy, dx]
    return acc.to(x.dtype)


def _tile(b: int, h: int, w: int, c: int):
    """(rows, columns) of output per block: up to 8 x 32, fewer rows while
    the grid would not fill the card twice."""
    tw = min(32, -(-w // _STRIP) * _STRIP)
    th = 8
    strips = b * -(-c // _LANES) * -(-w // tw)
    while th > 2 and strips * -(-h // th) < _WANT_BLOCKS:
        th //= 2
    return th, tw


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, H, W, C], w [k, k, C] or [k, k, 1, C], bias [C] or None ->
    [B, H, W, C] in x's dtype."""
    global launches
    w = _taps(w)
    if x.dim() != 4 or w.shape[2] != x.shape[-1]:
        raise ValueError(f"depthwise_conv2d: x [B, H, W, C] and w [k, k, C] do not match: "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if x.device.type == "cpu" and w.device.type == "cpu":
        out = depthwise_conv2d_plain(x, w)
    else:
        if x.device.type != "cuda" or w.device != x.device:
            raise ValueError(f"depthwise_conv2d: x and w must share one CUDA device, got "
                             f"{x.device} and {w.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"depthwise_conv2d: x dtype {x.dtype} is not float32/bfloat16")
        if w.dtype != x.dtype:
            raise TypeError(f"depthwise_conv2d: w dtype {w.dtype} is not x's {x.dtype}")
        k = w.shape[0]
        if k not in KERNEL_SIZES:
            raise NotImplementedError(f"depthwise_conv2d: no CUDA kernel for k={k} "
                                      f"(k in {KERNEL_SIZES})")
        x = x.contiguous()
        w = w.contiguous()
        b, h, wd, c = x.shape
        out = torch.empty_like(x)
        if out.numel():
            th, tw = _tile(b, h, wd, c)
            rc = _build.lib().vt_depthwise_conv2d(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, k, th, tw,
                int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
            _build.check(rc, "depthwise_conv2d")
            launches += 1
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
