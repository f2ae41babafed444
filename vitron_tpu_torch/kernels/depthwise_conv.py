"""Depthwise 2D convolution: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/depthwise_conv.py::_kernel`
(:35, pallas_call at :66 in `_dw_pallas` :54, entry `depthwise_conv2d` :138):

    x [B, H, W, C] (NHWC), w [k, k, C] (or [k, k, 1, C] HWIO), k odd
    y[b, h, w, c] = sum_{dy, dx} xpad[b, h + dy, w + dx, c] * w[dy, dx, c]

stride 1, SAME zero padding, float32 products and sums, y in x's dtype; the
bias is added after the kernel, as the JAX entry adds it. FocalNet's focal
levels (k = 3/5/7/9) call it.

The kernel is `csrc/depthwise_conv.cu` (k in {3, 5, 7, 9}, x and w both
float32 or both bfloat16): a block streams the input rows of one image's
segment of H, one strip of columns and one group of channels through a
ring of k + 1 rows in shared memory, each thread holding one 16-byte
vector of channels; `plan` sizes the grid. `depthwise_conv2d` launches it
for CUDA tensors and takes the plain version only for CPU tensors; other k
or dtypes on the card raise. When a gradient is wanted (grad mode on and x
or w requiring grad) it goes through `DepthwiseConv2d`, the port of the JAX
`custom_vjp` (`_dw_bwd` :119-133): dx is the same conv (the kernel on the
card, one more launch) of the cotangent with the spatially flipped filter,
dw the k^2 float32 reductions. `launches` counts kernel launches.
"""
from __future__ import annotations

import dataclasses

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

KERNEL_SIZES = (3, 5, 7, 9)
COLS = 4             # adjacent output columns a thread computes (csrc kCols)
MAX_THREADS = 256    # threads a block (csrc kMaxThreads)
SM_COUNT = 132       # the H100's SMs
WANT_BLOCKS = 4 * SM_COUNT
SMEM_LIMIT = 227 * 1024  # shared memory a block may take


def _smem_bytes(k: int, tw: int, channels: int, itemsize: int) -> int:
    """Shared memory of a block (csrc `smem_bytes`): the ring of k + 1 input
    rows of tw + k - 1 pixels, then the k x k taps, both in x's type."""
    ring = (k + 1) * (tw + k - 1) * channels * itemsize
    return -(-ring // 16) * 16 + k * k * channels * itemsize


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """The kernel's grid for one call: `vec` channels a thread (one 16-byte
    vector, or 1 where C is not a multiple of it), `lanes` threads across a
    block's `lanes * vec` channels, `tw` output columns and `hs` output rows
    a block; blocks (channel groups, column strips, B * segments)."""
    vec: int
    lanes: int
    tw: int
    hs: int
    grid: tuple
    itemsize: int

    @property
    def channels(self) -> int:
        return self.lanes * self.vec

    @property
    def threads(self) -> int:
        return self.lanes * self.tw // COLS

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def smem_bytes(self, k: int) -> int:
        return _smem_bytes(k, self.tw, self.channels, self.itemsize)


def plan(b: int, h: int, w: int, c: int, k: int, itemsize: int) -> DwPlan:
    """The grid for x [b, h, w, c] of `itemsize`-byte elements and a k x k
    kernel, from a sweep of block shapes at FocalNet-L's sites on the H100
    (PERF.md section 6). Up to 32 x 32 pixels at k <= 5 a block computes one
    output row with 16 lanes (128 bf16 or 64 float32 channels), and so do
    the 16 x 16 images at k = 7, unless that gives fewer blocks than SMs
    (ConvNeXt-T's and DaViT-T's narrower maps in bf16); otherwise 8 lanes
    and segments of H short enough for WANT_BLOCKS blocks (half as many at
    k >= 7 on larger images, whose rows cost more FMAs than loads), and at
    least one block for each SM. A ragged C takes 32 one-channel lanes.
    Strips are up to 64 columns wide, fewer where the ring would not fit."""
    full = 16 // itemsize
    vec = full if c % full == 0 else 1
    small = h * w <= 32 * 32
    wide = k <= 5 or (k == 7 and h * w <= 16 * 16)

    def grid_for(lanes: int) -> DwPlan:
        tw = min(64, MAX_THREADS * COLS // lanes, -(-w // COLS) * COLS)
        while tw > COLS and _smem_bytes(k, tw, lanes * vec, itemsize) > SMEM_LIMIT:
            tw = max(COLS, tw // 2 // COLS * COLS)
        per_seg = b * -(-c // (lanes * vec)) * -(-w // tw)
        want = WANT_BLOCKS // 2 if k >= 7 and not small else WANT_BLOCKS
        hs = 1 if small and k <= 5 else -(-h // min(h, -(-want // per_seg)))
        while hs > 1 and per_seg * -(-h // hs) < SM_COUNT:
            hs -= 1
        return DwPlan(vec, lanes, tw, hs, (-(-c // (lanes * vec)), -(-w // tw),
                                           b * -(-h // hs)), itemsize)

    if vec == 1:
        return grid_for(32)
    p = grid_for(16) if small and wide else None
    return p if p is not None and p.blocks >= SM_COUNT else grid_for(8)


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


def _launch(x: torch.Tensor, w: torch.Tensor, p: DwPlan) -> torch.Tensor:
    """One launch of the kernel on the grid `p`."""
    global launches
    x, w = _build.aligned16(x), _build.aligned16(w)
    b, h, wd, c = x.shape
    out = torch.empty_like(x)
    if out.numel():
        rc = _build.lib().vt_depthwise_conv2d(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), b, h, wd, c, w.shape[0], p.vec, p.lanes,
            p.tw, p.hs, int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
        _build.check(rc, "depthwise_conv2d")
        launches += 1
    return out


def _dw_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, needs=(True, True)):
    """The JAX `_dw_bwd` at the cotangent g [B, H, W, C]: dx = the conv of g
    with w[::-1, ::-1] (the kernel on CUDA tensors), dw[dy, dx, c] = sum over
    (b, h, w) of xpad[b, h + dy, w + dx, c] g[b, h, w, c] in float32.
    -> (dx, dw), None where `needs` is false."""
    dx = dw = None
    if needs[0]:
        dx = _dw(g, torch.flip(w, (0, 1)).contiguous().to(g.dtype)).to(x.dtype)
    if needs[1]:
        k = w.shape[0]
        p = k // 2
        b, h, wd, c = x.shape
        xp = torch.nn.functional.pad(x.to(torch.float32), (0, 0, p, p, p, p))
        g32 = g.to(torch.float32)
        dw = torch.stack([(xp[:, dy:dy + h, dx_:dx_ + wd] * g32).sum((0, 1, 2))
                          for dy in range(k) for dx_ in range(k)]).reshape(k, k, c).to(w.dtype)
    return dx, dw


class DepthwiseConv2d(torch.autograd.Function):
    """depthwise_conv2d (without its bias) with gradients for x and w [k, k, C]."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _dw(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return _dw_bwd(x, w, g.contiguous(), ctx.needs_input_grad)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """x [B, H, W, C], w [k, k, C] or [k, k, 1, C], bias [C] or None ->
    [B, H, W, C] in x's dtype."""
    w = _taps(w)
    if x.dim() != 4 or w.shape[2] != x.shape[-1]:
        raise ValueError(f"depthwise_conv2d: x [B, H, W, C] and w [k, k, C] do not match: "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = DepthwiseConv2d.apply(x, w)
    else:
        out = _dw(x, w)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _dw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv without its bias: the plain version for CPU tensors, else
    the kernel."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return depthwise_conv2d_plain(x, w)
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
    return _launch(x, w, plan(*x.shape, k, x.element_size()))
