"""GEGLU feed-forward: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/geglu_ff.py::_kernel`
(:45, pallas_call at :90, entry `geglu_ff_fused` :163):

    [a | g] = x @ W1 + b1            x [M, C], W1 [C, 2F], b1 [2F]
    t       = (a * gelu(g)) in x.dtype
    out     = t @ W2 + b2            W2 [F, C], b2 [C]

with float32 products and the exact erf gelu, as the reference FeedForward
and the JAX package's XLA form `_xla_geglu` (:113) compute it (the Pallas
kernel used the tanh form; ROADMAP C2). The hidden tensor is cast to the
input dtype before the second product, as both JAX forms do. The TPU gate
`geglu_ff.usable` recorded TPU tiling facts, so here every CUDA call
launches the kernel.

The kernel is `csrc/geglu_ff.cu`: two tiled GEMMs, the first with the GEGLU
epilogue writing t [M, F] in x's dtype, the second t @ W2 + b2, split over
F when its output tiles cannot fill the card; bf16 on the tensor cores,
float32 on the CUDA cores. Every site is bound by operations (PERF.md). It
takes C and F that are multiples of 8: the SD UNet's widths C in
{320, 640, 1280} and the video UNet's {512, 1024, 2048}, F = 4C.
`geglu_ff` launches it for CUDA tensors (float32 or bfloat16) and takes the
plain version only for CPU tensors; other shapes raise. When a gradient is
wanted (grad mode on and an input requiring grad) it goes through
`GegluFF`, the port of the JAX `custom_vjp` (`_vjp_bwd` :130-134): the
backward is the VJP of the XLA form, recomputed in torch ops in x's dtype
(`_vjp_bwd`), on every device; weights that need no gradient get none.
`launches` counts the calls that launched the kernel (its two GEMMs count
as one).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

_TILE = 128              # output rows and columns per block (csrc kBM, kBN)
_SMS = 132               # the H100's SMs
_MIN_SPLIT_DEPTH = 256   # hidden columns per split of the second product


def geglu_ff_plain(x2d, proj_w, proj_b, out_w, out_b):
    """Plain PyTorch version of the kernel's arithmetic."""
    f32 = torch.float32
    h = x2d.to(f32) @ proj_w.to(f32) + proj_b.to(f32)
    a, g = h.chunk(2, dim=-1)
    t = (a * F.gelu(g)).to(x2d.dtype).to(f32)
    return (t @ out_w.to(f32) + out_b.to(f32)).to(x2d.dtype)


def _splits(m: int, c: int, f: int) -> int:
    """Depth splits of the second product [M, F] @ [F, C]: enough blocks for
    two waves of the card when its output tiles are fewer than one."""
    tiles = -(-m // _TILE) * -(-c // _TILE)
    if tiles >= _SMS:
        return 1
    return max(1, min(-(-2 * _SMS // tiles), f // _MIN_SPLIT_DEPTH))


def _vjp_bwd(x2d, proj_w, proj_b, out_w, out_b, g, needs=(True,) * 5):
    """The JAX `_vjp_bwd`: the VJP of `_xla_geglu` (:113-117, h = x W1 + b1,
    t = a * gelu_erf(gate), out = t W2 + b2) at the cotangent g [M, C], in
    x's dtype; -> (dx, dW1, db1, dW2, db2), None where `needs` is false."""
    h = x2d @ proj_w + proj_b
    a, gate = h.chunk(2, dim=-1)
    cdf = 0.5 * (1.0 + torch.erf(gate * math.sqrt(0.5)))
    gelu = gate * cdf
    dt = g @ out_w.T
    d_gate = dt * a * (cdf + gate * torch.exp(-0.5 * gate * gate) / math.sqrt(2.0 * math.pi))
    dh = torch.cat([dt * gelu, d_gate], dim=-1)
    return (dh @ proj_w.T if needs[0] else None, x2d.T @ dh if needs[1] else None,
            dh.sum(0) if needs[2] else None, (a * gelu).T @ g if needs[3] else None,
            g.sum(0) if needs[4] else None)


class GegluFF(torch.autograd.Function):
    """geglu_ff on x [M, C] with gradients for x and the weights."""

    @staticmethod
    def forward(ctx, x2d, proj_w, proj_b, out_w, out_b):
        ctx.save_for_backward(x2d, proj_w, proj_b, out_w, out_b)
        return _geglu_ff(x2d, proj_w, proj_b, out_w, out_b)

    @staticmethod
    def backward(ctx, g):
        return _vjp_bwd(*ctx.saved_tensors, g, ctx.needs_input_grad)


def geglu_ff(x, proj_w, proj_b, out_w, out_b):
    """x [..., C] -> [..., C]: the reference GEGLU FeedForward."""
    c = x.shape[-1]
    f = out_w.shape[0]
    if (proj_w.dim() != 2 or tuple(proj_w.shape) != (c, 2 * f)
            or tuple(out_w.shape) != (f, c) or tuple(proj_b.shape) != (2 * f,)
            or tuple(out_b.shape) != (c,)):
        raise ValueError(f"geglu_ff: x [..., {c}], W1 {tuple(proj_w.shape)}, b1 "
                         f"{tuple(proj_b.shape)}, W2 {tuple(out_w.shape)}, b2 "
                         f"{tuple(out_b.shape)} do not match [C, 2F], [2F], [F, C], [C]")
    tensors = (x, proj_w, proj_b, out_w, out_b)
    x2d = x.reshape(-1, c)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        out = GegluFF.apply(x2d, proj_w, proj_b, out_w, out_b)
    else:
        out = _geglu_ff(x2d, proj_w, proj_b, out_w, out_b)
    return out.reshape(x.shape)


def _geglu_ff(x2d, proj_w, proj_b, out_w, out_b):
    """x2d [M, C] -> [M, C]: the plain version for CPU tensors, else the
    kernel."""
    global launches
    tensors = (x2d, proj_w, proj_b, out_w, out_b)
    c, f = x2d.shape[1], out_w.shape[0]
    if all(t.device.type == "cpu" for t in tensors):
        return geglu_ff_plain(x2d, proj_w, proj_b, out_w, out_b)
    if any(t.device.type != "cuda" or t.device != x2d.device for t in tensors):
        raise ValueError("geglu_ff: tensors must share one CUDA device")
    if x2d.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x2d.dtype
                                                              for t in tensors):
        raise TypeError(f"geglu_ff: x and the weights must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if c % 8 or f % 8 or f == 0:
        raise NotImplementedError(f"geglu_ff: no CUDA kernel for C={c}, F={f} (C and F "
                                  "multiples of 8)")
    x2d = _build.aligned16(x2d)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (proj_w, out_w)):
        raise ValueError("geglu_ff: W1 and W2 must be contiguous and 16-byte aligned")
    if not (proj_b.is_contiguous() and out_b.is_contiguous()):
        raise ValueError("geglu_ff: the biases must be contiguous")
    m = x2d.shape[0]
    out = torch.empty((m, c), dtype=x2d.dtype, device=x2d.device)
    if m == 0:
        return out
    hidden = torch.empty((m, f), dtype=x2d.dtype, device=x2d.device)
    splits = _splits(m, c, f)
    part = (torch.empty((splits, m, c), dtype=torch.float32, device=x2d.device)
            if splits > 1 else None)
    rc = _build.lib().vt_geglu_ff(
        x2d.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(), out_w.data_ptr(),
        out_b.data_ptr(), hidden.data_ptr(), part.data_ptr() if part is not None else None,
        out.data_ptr(), m, c, f, splits, int(x2d.dtype == torch.bfloat16),
        _build.stream_handle(x2d.device))
    _build.check(rc, "geglu_ff")
    launches += 1
    return out
