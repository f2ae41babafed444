"""int4 weight-only matrix product: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/int4_matmul.py::_kernel`
(pallas_call at :108). The kernel is `csrc/int4_matmul.cu`; its note says
what bounds it on the H100 (device-memory bandwidth in decode) and how the
design answers that (packed bytes read once, split-K GEMV for M <= 8, a
tiled FMA GEMM for prefill).

`int4_matmul(x, q4, s)` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. `launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

GEMV_MAX_M = 8
_GEMV_COLS = 128   # columns per GEMV block (csrc kGemvCols)
_TARGET_BLOCKS = 264  # two waves of the H100's 132 SMs
_MIN_SPLIT_ROWS = 64


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] packed int8 -> [..., K, N] int8 in [-8, 7]; packed row r
    holds K row 2r in the low nibble, 2r+1 in the high one."""
    u = packed.to(torch.int16)
    lo = u & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)  # sign-extend the low nibble
    hi = u >> 4  # arithmetic shift of the sign-extended byte
    stacked = torch.stack([lo, hi], dim=-2).to(torch.int8)  # [..., K/2, 2, N]
    return stacked.reshape(*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])


def int4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack, product in float32, per-column scale,
    cast to x.dtype (the kernel's arithmetic, summed in another order)."""
    w = unpack_int4(q4).to(torch.float32)
    return ((x.to(torch.float32) @ w) * s.to(torch.float32)).to(x.dtype)


def _splits(m: int, k2: int, n: int) -> int:
    """Row splits of the decode GEMV so the grid fills the card."""
    if m > GEMV_MAX_M:
        return 1
    col_blocks = -(-n // _GEMV_COLS)
    want = -(-_TARGET_BLOCKS // col_blocks)
    return max(1, min(want, k2 // _MIN_SPLIT_ROWS))


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (float32/bfloat16) @ int4 q4 [K/2, N] (int8), scale s [1, N]
    float32 -> [M, N] in x.dtype."""
    global launches
    if x.dim() != 2 or q4.dim() != 2 or x.shape[1] != 2 * q4.shape[0]:
        raise ValueError(f"int4_matmul: x {tuple(x.shape)} and q4 {tuple(q4.shape)} "
                         "must be [M, K] and [K/2, N]")
    m, k = x.shape
    k2, n = q4.shape
    if tuple(s.shape) != (1, n):
        raise ValueError(f"int4_matmul: scale shape {tuple(s.shape)} != (1, {n})")
    devices = {x.device.type, q4.device.type, s.device.type}
    if devices == {"cpu"}:
        return int4_matmul_plain(x, q4, s)
    if devices != {"cuda"} or len({x.device, q4.device, s.device}) != 1:
        raise ValueError(f"int4_matmul: tensors must share one CUDA device, got "
                         f"{x.device}, {q4.device}, {s.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int4_matmul: x dtype {x.dtype} is not float32/bfloat16")
    if q4.dtype != torch.int8 or s.dtype != torch.float32:
        raise TypeError(f"int4_matmul: q4 must be int8 and s float32, got {q4.dtype}, {s.dtype}")
    if not (x.is_contiguous() and q4.is_contiguous() and s.is_contiguous()):
        raise ValueError("int4_matmul: x, q4 and s must be contiguous")
    if n % 4 or q4.data_ptr() % 4:
        raise ValueError(f"int4_matmul: N={n} must be a multiple of 4 and q4 4-byte aligned")
    if m == 0:
        return torch.empty((0, n), dtype=x.dtype, device=x.device)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    splits = _splits(m, k2, n)
    part = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    rc = _build.lib().vt_int4_matmul(
        x.data_ptr(), q4.data_ptr(), s.data_ptr(), y.data_ptr(),
        part.data_ptr() if part is not None else None, m, k2, n, splits,
        int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check(rc, "int4_matmul")
    launches += 1
    return y
