"""Q1, the W4A8 product: the hand CUDA kernel and its plain twin.

Replaces no Pallas kernel: the JAX package computes this in XLA
(`vitron_tpu/kernels/quantization.py::_w4a8_matmul` :130, a `dot_general`
of s8 x s4 with int32 sums), and no PyTorch call takes B1's int4 packing.

    x [M, K] float32 / bfloat16, q4 [K/2, N] int8 (B1's packing), s [1, N]
    sx[m] = max(max_k |x[m]|, 1e-8) / 127, or a static scale
    xq = clamp(round(x / sx), -127, 127)                       (int8)
    w4a8_matmul(x, q4, s) = ((xq @ q) * sx) * s                (in x's dtype)

JAX pads fewer than 8 rows to 8 for its MXU; that changes nothing per row,
so nothing here pads. The kernel is `csrc/w4a8_matmul.cu` (its note says
what bounds it and how it is built): one entry that quantizes the rows and
then runs a dp4a GEMV (M <= 8, split over the rows of K with exact int32
atomics) or an mma.sync s8 GEMM. It allocates nothing and syncs with no
host value, so it is captured in the decode graphs. `w4a8_matmul` launches
it for CUDA tensors and takes the plain version only for CPU tensors;
`launches` counts kernel launches. Inference only, as in JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from vitron_tpu_torch.kernels import _build
from vitron_tpu_torch.kernels.int4_matmul import unpack_int4

launches = 0  # kernel launches since the last reset (CPU calls do not count)

GEMV_MAX_M = 8
_MV_COLS = 128  # columns a GEMV block (csrc kMvCols)
_TARGET_BLOCKS = 264  # one wave of two blocks on each of the H100's 132 SMs
_MIN_SPLIT_GROUPS = 64  # groups of 4 K rows a split: 8 a warp


def quantize_rows(x: torch.Tensor, static_sx: Optional[torch.Tensor] = None):
    """x [M, K] -> (xq int8 [M, K], sx float32 [M, 1]): each row by its
    absmax, divided exactly (a tensor divisor), or every row by the static
    scale (a float32 tensor of one element)."""
    xf = x.to(torch.float32)
    if static_sx is not None:
        sx = static_sx.to(torch.float32).reshape(1, 1).expand(xf.shape[0], 1)
    else:
        amax = xf.abs().amax(dim=-1, keepdim=True)
        sx = torch.clamp(amax, min=1e-8) / torch.full_like(amax, 127.0)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def exact_int_dot(a: torch.Tensor, b: torch.Tensor, b_max: int = 127) -> torch.Tensor:
    """int8 a [M, K] @ int8 b [K, N] (|b| <= b_max) -> the exact int32 sums,
    on any device: a float product of the integer values, float32 where
    every partial sum stays below 2^24 (127 b_max K < 2^24), else float64.
    On the card this needs full float32 products (TF32 off, the default)."""
    dt = torch.float32 if 127 * b_max * a.shape[-1] < 2 ** 24 else torch.float64
    return (a.to(dt) @ b.to(dt)).to(torch.int32)


def w4a8_matmul_plain(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                      static_sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the kernel's integers and its two float32
    products, in JAX's order."""
    xq, sx = quantize_rows(x, static_sx)
    acc = exact_int_dot(xq, unpack_int4(q4), b_max=8)
    return (acc.to(torch.float32) * sx * s.to(torch.float32)).to(x.dtype)


def _splits(m: int, k: int, n: int) -> int:
    """Row splits of the GEMV so that its grid is about one wave."""
    if m > GEMV_MAX_M:
        return 1
    strips = -(-n // _MV_COLS)
    return max(1, min(round(_TARGET_BLOCKS / strips), (k // 4) // _MIN_SPLIT_GROUPS))


def w4a8_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor,
                static_sx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [M, K] (float32/bfloat16) -> [M, N] in x.dtype; q4 [K/2, N] int8,
    s [1, N] float32, static_sx a float32 tensor of one element or None."""
    global launches
    if x.dim() != 2 or q4.dim() != 2 or x.shape[1] != 2 * q4.shape[0]:
        raise ValueError(f"w4a8_matmul: x {tuple(x.shape)} and q4 {tuple(q4.shape)} "
                         "must be [M, K] and [K/2, N]")
    m, k = x.shape
    n = q4.shape[1]
    if tuple(s.shape) != (1, n):
        raise ValueError(f"w4a8_matmul: scale shape {tuple(s.shape)} != (1, {n})")
    if static_sx is not None and static_sx.numel() != 1:
        raise ValueError("w4a8_matmul: the static scale must have one element")
    tensors = [t for t in (x, q4, s, static_sx) if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return w4a8_matmul_plain(x, q4, s, static_sx)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("w4a8_matmul: tensors must share one CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w4a8_matmul: x dtype {x.dtype} is not float32/bfloat16")
    if q4.dtype != torch.int8 or s.dtype != torch.float32 or (
            static_sx is not None and static_sx.dtype != torch.float32):
        raise TypeError("w4a8_matmul: q4 must be int8, s and the static scale float32")
    if k % 16 or n % 16:
        raise NotImplementedError(f"w4a8_matmul: no CUDA kernel for K={k}, N={n} (K and N "
                                  "multiples of 16)")
    x, q4, s = _build.aligned16(x), _build.aligned16(q4), s.contiguous()
    if m == 0:
        return torch.empty((0, n), dtype=x.dtype, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    splits = _splits(m, k, n)
    acc = ticket = None
    if splits > 1:
        acc = torch.empty((m, n), dtype=torch.int32, device=x.device)
        ticket = torch.empty((-(-n // _MV_COLS),), dtype=torch.int32, device=x.device)
    rc = _build.lib().vt_w4a8_matmul(
        x.data_ptr(), q4.data_ptr(), s.data_ptr(),
        static_sx.data_ptr() if static_sx is not None else None, y.data_ptr(), xq.data_ptr(),
        sx.data_ptr(), acc.data_ptr() if acc is not None else None,
        ticket.data_ptr() if ticket is not None else None, m, k // 2, n, splits,
        int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check(rc, "w4a8_matmul")
    launches += 1
    return y
