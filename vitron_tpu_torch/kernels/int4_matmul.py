"""int4 weight-only matrix product: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/int4_matmul.py::_kernel`
(pallas_call at :108). The kernel is `csrc/int4_matmul.cu`; its note says
what bounds it on the H100 (device-memory bandwidth in decode, operations
in prefill and training) and how the design answers that: a split-K GEMV
for M <= 8 (bf16 x on the tensor cores; the last block of a column strip
adds the splits in a fixed order, counted on `_tickets`), a bf16
tensor-core GEMM (mma.sync, nibbles unpacked straight into B fragments) for
larger M with bf16 x, and an FMA GEMM for larger M with float32 x (TF32
would round x).

`int4_matmul(x, q4, s)` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. When x needs a gradient it goes through
`Int4Matmul`, the port of the JAX `custom_vjp` (`_int4_bwd` :67-75): the
backward is dx = g @ dequantize(q4, s).T in g's dtype, in plain torch (the
JAX backward is XLA ops too). `launches` counts kernel launches.
"""
from __future__ import annotations

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)
_tickets = {}  # (device, stream) -> int32 counters of the GEMV's split-K, 0 between launches

GEMV_MAX_M = 8
# columns per GEMV block (csrc kMvCols for bf16 x, kGemvCols for float32 x)
_GEMV_COLS = {torch.bfloat16: 128, torch.float32: 512}
_TARGET_BLOCKS = 264  # one wave of two blocks on each of the H100's 132 SMs
_MIN_SPLIT_ROWS = 256  # a split gives each of a block's 8 warps 4 k16 steps (32 rows)


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


def _ticket(device, stream: int, strips: int) -> torch.Tensor:
    """The GEMV's per-column-strip counters for launches on `stream`: zeroed
    once, and every launch leaves them 0 (its last block per strip resets
    its own)."""
    t = _tickets.get((device, stream))
    if t is None or t.numel() < strips:
        t = torch.zeros(max(strips, 256), dtype=torch.int32, device=device)
        _tickets[(device, stream)] = t
    return t


def _splits(m: int, k2: int, n: int, dtype) -> int:
    """Row splits of the decode GEMV so that its grid is about one wave."""
    if m > GEMV_MAX_M:
        return 1
    strips = -(-n // _GEMV_COLS[dtype])
    return max(1, min(round(_TARGET_BLOCKS / strips), k2 // _MIN_SPLIT_ROWS))


class Int4Matmul(torch.autograd.Function):
    """x @ dequantize(q4, s) with a gradient for x (the base stays frozen)."""

    @staticmethod
    def forward(ctx, x, q4, s):
        ctx.save_for_backward(q4, s)
        return _int4_matmul(x, q4, s)

    @staticmethod
    def backward(ctx, g):
        q4, s = ctx.saved_tensors
        w = (unpack_int4(q4).to(torch.float32) * s).to(g.dtype)  # [K, N]
        return g @ w.T, None, None


def int4_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [M, K] (float32/bfloat16) @ int4 q4 [K/2, N] (int8), scale s [1, N]
    float32 -> [M, N] in x.dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Int4Matmul.apply(x, q4, s)
    return _int4_matmul(x, q4, s)


def _int4_matmul(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
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
    splits = _splits(m, k2, n, x.dtype)
    stream = _build.stream_handle(x.device)
    part = ticket = None
    if splits > 1:
        part = torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
        ticket = _ticket(x.device, stream, -(-n // _GEMV_COLS[x.dtype]))
    rc = _build.lib().vt_int4_matmul(
        x.data_ptr(), q4.data_ptr(), s.data_ptr(), y.data_ptr(),
        part.data_ptr() if part is not None else None,
        ticket.data_ptr() if ticket is not None else None, m, k2, n, splits,
        int(x.dtype == torch.bfloat16), stream)
    _build.check(rc, "int4_matmul")
    launches += 1
    return y
