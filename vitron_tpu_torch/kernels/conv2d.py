"""3x3 stride-1 SAME convolution (B9): the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/conv2d.py::_kernel`
(:39, pallas_call at :99 in `_conv3x3` :70, entry `conv3x3_same` :150,
custom VJP :122-147):

    x [B, H, W, C] (NHWC), w [3, 3, C, D] (HWIO), b [D] or None
    conv3x3_same(x, w, b) = conv(x, w) (+ b), zero padding of 1

The eligibility rule is part of the function, as in JAX. At an eligible
shape (C and D multiples of 128, W of 8, and the TPU tiling's VMEM need
within its limit, `eligible`) the TPU kernel casts x and w to bf16 (for
float32 and bf16 inputs), sums the nine tap products in float32 and
returns x's dtype; so does this module, on every device (JAX's
`interpret=True` result, and what the TPU computes). At any other shape the
result is the exact conv in the input dtype (`F.conv2d`, JAX's
`lax.conv_general_dilated` fallback :87-93), on the CPU and on the card
alike. The bias is added after the conv with PyTorch's type promotion,
which is JAX's here: a bf16 conv plus a float32 bias is float32.

The kernel is `csrc/conv3x3.cu`: an implicit GEMM (M = B H W pixels,
depth 9C, D columns) on Hopper's wgmma, fed by TMA. A block owns 128
pixels, a rectangle of bb images x bh rows x bw columns (`plan_boxes`),
whose A tile of each tap and 64 channels is one 4-D TMA box of x: TMA's
zero fill outside the tensor is the SAME padding, so no padded copy of x
exists. Float32 x and w are cast to bf16 once, before the launch (JAX's
`_conv3x3` casts in XLA, :98 and :118), and the same kernel then stores
float32 sums. `conv3x3_same` launches it for CUDA tensors at eligible
shapes (and raises when it cannot), and takes the plain version only for
CPU tensors. `launches` counts kernel launches. A gradient goes through
`Conv3x3`, a `torch.autograd.Function` in place of the JAX `custom_vjp`:
dx is the same conv (the kernel on the card) of g with the flipped,
in/out-swapped filter; dw is nine [C, BHW] @ [BHW, D] products of the
unrounded, padded x taps with g in float32, cast to w's dtype (plain
`torch.matmul`: JAX computes them in XLA, outside any Pallas kernel).

No model path calls it, in JAX or in the port: the UNets' 3x3 convs run
`layers.conv2d` (cuDNN), whose float32 arithmetic the bf16 taps would
change.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

_VMEM_LIMIT = 100 * 1024 * 1024  # the TPU kernel's VMEM budget, part of its rule
BLOCK_PIXELS = 128  # output pixels a block of the kernel owns (csrc kBM)
# every (bb, bh, bw) pixel rectangle the planner may choose: powers of two
# with product 128 and bw >= 8 (eligible shapes have W a multiple of 8)
BOX_SHAPES = tuple((BLOCK_PIXELS // (bh * bw), bh, bw) for bw in (128, 64, 32, 16, 8)
                   for bh in (1, 2, 4, 8, 16) if bh * bw <= BLOCK_PIXELS)


def _pick_block(total: int, target: int, quantum: int = 1) -> int:
    """Largest divisor of `total` that is <= target and a multiple of
    quantum; `total` when there is none (JAX's `_pick_block`)."""
    for cand in range(min(target, total), quantum - 1, -1):
        if total % cand == 0 and cand % quantum == 0:
            return cand
    return total


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type of the taps at an eligible shape: bf16 for float32 and bf16
    inputs, the input type otherwise (JAX's `cdtype`)."""
    return torch.bfloat16 if dtype in (torch.float32, torch.bfloat16) else dtype


def eligible(x_shape, d: int, dtype: torch.dtype) -> bool:
    """JAX's rule (`_conv3x3` :74-90) for x [B, H, W, C] and D output
    channels: the TPU tiling's row block bh (the largest divisor of H up to
    64 whose VMEM need fits) must fit, C and D be multiples of 128 and W of 8."""
    _, h, ww, c = x_shape
    isz = compute_dtype(dtype).itemsize
    bd = _pick_block(d, 512, 128)

    def need(bh):  # x window + the taps + the weights + the accumulator
        return ((bh + 2) * (ww + 2) * c + 9 * bh * ww * c + 9 * c * bd) * isz + 2 * bh * ww * bd * 4

    bh = h
    for cand in range(min(64, h), 0, -1):
        if h % cand == 0 and need(cand) <= _VMEM_LIMIT:
            bh = cand
            break
    return need(bh) <= _VMEM_LIMIT and c % 128 == 0 and d % 128 == 0 and ww % 8 == 0 \
        and h % bh == 0


def plan_boxes(b: int, h: int, w: int):
    """(bb, bh, bw): the pixel rectangle of one block of the kernel, from
    BOX_SHAPES, that tiles [b, h, w] with the fewest blocks (ties: the
    widest rows, then the most of them). Rectangles overrun the edges of a
    ragged shape; the kernel masks those pixels. The A tile of a tap is the
    TMA box {64, bw, bh, bb} (64 bf16 channels = 128 bytes, each extent at
    most 256)."""
    def blocks(box):
        bb, bh, bw = box
        return -(-b // bb) * -(-h // bh) * -(-w // bw)

    return min(BOX_SHAPES, key=lambda box: (blocks(box), -box[2], -box[1]))


def box_tiles(b: int, h: int, w: int, box):
    """The (b0, h0, w0) origin of every block's rectangle, in the kernel's
    order (w fastest, then h, then b)."""
    bb, bh, bw = box
    return [(b0, h0, w0) for b0 in range(0, b, bb) for h0 in range(0, h, bh)
            for w0 in range(0, w, bw)]


def conv3x3_exact(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The ineligible shapes' function: the conv in x's dtype, w cast to it."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype), padding=1)
    return out.permute(0, 2, 3, 1)


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the eligible shapes' function: x and w
    rounded to the tap type, the nine tap products of the padded x in
    float32 (products of bf16 values are exact there), the result in x's
    dtype. It equals the kernel up to the order of float32 sums."""
    cd, f32 = compute_dtype(x.dtype), torch.float32
    h, ww = x.shape[1], x.shape[2]
    xp = F.pad(x.to(cd).to(f32), (0, 0, 1, 1, 1, 1))
    wr = w.to(cd).to(f32)
    out = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + h, dx:dx + ww, :] @ wr[dy, dx]
            out = t if out is None else out + t
    return out.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or w.shape[0] != 3 or w.shape[1] != 3 \
            or w.shape[2] != x.shape[-1]:
        raise ValueError(f"conv3x3_same: x [B, H, W, C] and w [3, 3, C, D] do not match: "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")


def _conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The function without the bias: the kernel's (or its plain twin's on
    the CPU) at eligible shapes, the exact conv at the others."""
    _check(x, w)
    if not eligible(x.shape, w.shape[-1], x.dtype):
        return conv3x3_exact(x, w)
    if x.device.type == "cpu" and w.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("conv3x3_same: x and w must share one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"conv3x3_same: no CUDA kernel for {x.dtype} (float32 and "
                                  "bfloat16 only)")
    return _launch(x, w, plan_boxes(*x.shape[:3]))


def _launch(x: torch.Tensor, w: torch.Tensor, box) -> torch.Tensor:
    """One launch of the kernel with the pixel rectangle `box` (the planner's
    choice; the card tests force each of BOX_SHAPES). Float32 x and w are
    cast to bf16 first, as JAX's `_conv3x3` casts them (:98, :118)."""
    global launches
    bf16 = torch.bfloat16
    xb, wb = _build.aligned16(x.to(bf16)), _build.aligned16(w.to(bf16))
    b, h, ww, c = x.shape
    d = w.shape[-1]
    y = torch.empty((b, h, ww, d), dtype=x.dtype, device=x.device)
    if y.numel():
        rc = _build.lib().vt_conv3x3(xb.data_ptr(), wb.data_ptr(), y.data_ptr(), b, h, ww, c, d,
                                     *box, int(x.dtype == torch.float32),
                                     _build.stream_handle(x.device))
        _build.check(rc, "conv3x3_same")
        launches += 1
    return y


def _vjp(x, w, g, conv):
    """(dx, dw) of the JAX backward (:126-147), with `conv` for dx."""
    # dx: the same 3x3 SAME conv of g with the spatially flipped,
    # in/out-swapped filter
    dx = conv(g, w.flip(0, 1).transpose(2, 3).to(g.dtype).contiguous())
    # dw[dy, dx] = (padded x tap)^T @ g: unrounded x, float32 sums
    b, h, ww, c = x.shape
    f32 = torch.float32
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    gf = g.reshape(b * h * ww, -1).to(f32)
    taps = [xp[:, dy:dy + h, dx_:dx_ + ww, :].reshape(b * h * ww, c).to(f32).T @ gf
            for dy in range(3) for dx_ in range(3)]
    return dx.to(x.dtype), torch.stack(taps).reshape(3, 3, c, -1).to(w.dtype)


def conv3x3_vjp_plain(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The backward with the plain function for dx, on any device: what
    `Conv3x3` gives on the CPU, for holding the card's gradients."""
    def conv(a, k):
        return conv3x3_plain(a, k) if eligible(a.shape, k.shape[-1], a.dtype) \
            else conv3x3_exact(a, k)

    return _vjp(x, w, g, conv)


class Conv3x3(torch.autograd.Function):
    """The JAX custom VJP (`_conv3x3_fwd` / `_conv3x3_bwd`, :122-147): dx
    through the kernel on the card at eligible shapes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _conv3x3(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _vjp(x, w, g, _conv3x3)


def conv3x3_same(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv, NHWC x HWIO -> NHWC (+ b). Differentiable
    in x and w (dx reuses the kernel)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = Conv3x3.apply(x, w)
    else:
        out = _conv3x3(x, w)
    return out if b is None else out + b
