"""Group-norm statistics: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/group_norm.py::_kernel`
(:44, pallas_call at :75, entry `group_norm_sums` :114):

    x [B, R, C] (float32 or bfloat16) -> [B, 2, C] float32
    out[b, 0, c] = sum_r x[b, r, c],  out[b, 1, c] = sum_r x[b, r, c]^2

The grouping over channels and the affine apply stay in the caller
(`models/diffusion/layers.group_norm`). On the TPU the kernel sat behind
`VITRON_GN=pallas` because XLA fuses the sums into their producer there;
PyTorch has no such fusion, so every CUDA call launches this kernel.

The kernel is `csrc/group_norm.cu`: rows are split over blocks and a second
pass adds the per-split partial sums in a fixed order, so the result is the
same bits run to run (no atomics). `group_norm_sums` launches it for CUDA
tensors and takes the plain version only for CPU tensors. `launches` counts
kernel launches.
"""
from __future__ import annotations

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

_CH_TILE = 32          # channels per block (csrc kChTile)
_TARGET_BLOCKS = 528   # four waves of the H100's 132 SMs
_MIN_SPLIT_ROWS = 64


def group_norm_sums_plain(x3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: float32 sums over the rows."""
    x32 = x3.to(torch.float32)
    return torch.stack([x32.sum(dim=1), (x32 * x32).sum(dim=1)], dim=1)


def _splits(b: int, r: int, c: int) -> int:
    """Row splits so the grid fills the card."""
    tiles = b * -(-c // _CH_TILE)
    want = -(-_TARGET_BLOCKS // tiles)
    return max(1, min(want, r // _MIN_SPLIT_ROWS))


def group_norm_sums(x3: torch.Tensor) -> torch.Tensor:
    """x3 [B, R, C] -> [B, 2, C] float32 (sum and sum of squares over R)."""
    global launches
    if x3.dim() != 3:
        raise ValueError(f"group_norm_sums: x must be [B, R, C], got {tuple(x3.shape)}")
    if x3.device.type == "cpu":
        return group_norm_sums_plain(x3)
    if x3.device.type != "cuda":
        raise ValueError(f"group_norm_sums: x must be on the CPU or a CUDA device, not "
                         f"{x3.device}")
    if x3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"group_norm_sums: x dtype {x3.dtype} is not float32/bfloat16")
    if not x3.is_contiguous():
        raise ValueError("group_norm_sums: x must be contiguous")
    b, r, c = x3.shape
    out = torch.empty((b, 2, c), dtype=torch.float32, device=x3.device)
    if out.numel() == 0:
        return out
    if r == 0:
        return out.zero_()
    splits = _splits(b, r, c)
    part = (torch.empty((b, splits, 2, c), dtype=torch.float32, device=x3.device)
            if splits > 1 else None)
    rc = _build.lib().vt_group_norm_sums(
        x3.data_ptr(), out.data_ptr(), part.data_ptr() if part is not None else None,
        b, r, c, splits, int(x3.dtype == torch.bfloat16), _build.stream_handle(x3.device))
    _build.check(rc, "group_norm_sums")
    launches += 1
    return out
