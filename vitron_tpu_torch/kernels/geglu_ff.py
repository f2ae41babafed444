"""Fused GEGLU feed-forward: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel `vitron_tpu/kernels/geglu_ff.py::_kernel`
(:45, pallas_call at :90, entry `geglu_ff_fused` :163):

    [a | g] = x @ W1 + b1            x [M, C], W1 [C, 2F], b1 [2F]
    t       = (a * gelu(g)) in x.dtype
    out     = t @ W2 + b2            W2 [F, C], b2 [C]

with float32 products and the exact erf gelu, as the reference FeedForward
and the JAX package's XLA form `_xla_geglu` (:113) compute it (the Pallas
kernel used the tanh form; ROADMAP C2). The hidden tensor is cast to the
input dtype before the second product, as both JAX forms do, and never
reaches device memory: the kernel `csrc/geglu_ff.cu` keeps each [rows, FC]
slice of it in shared memory. The TPU gate `geglu_ff.usable` recorded TPU
tiling facts, so here every CUDA call launches the kernel.

The kernel takes C in {320, 640, 1280} (the SD and video UNet widths) and
F a multiple of its hidden chunk FC (32, 64, 128 at those widths), in
float32 or bfloat16; other shapes raise.
`geglu_ff` launches it for CUDA tensors and takes the plain version only for
CPU tensors. `launches` counts kernel launches.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

KERNEL_WIDTHS = (320, 640, 1280)
_ACC_ELEMS = 20480       # rows x C accumulated per block (csrc kAccElems)
_SMS = 132               # the H100's SMs; one block of this kernel fits on each


def geglu_ff_plain(x2d, proj_w, proj_b, out_w, out_b):
    """Plain PyTorch version of the kernel's arithmetic."""
    f32 = torch.float32
    h = x2d.to(f32) @ proj_w.to(f32) + proj_b.to(f32)
    a, g = h.chunk(2, dim=-1)
    t = (a * F.gelu(g)).to(x2d.dtype).to(f32)
    return (t @ out_w.to(f32) + out_b.to(f32)).to(x2d.dtype)


def _f_chunk(c: int) -> int:
    """Hidden columns per kernel step at width c (csrc f_chunk)."""
    return 2048 // (_ACC_ELEMS // c)


def _split_f(m: int, c: int, f: int):
    """(splits, chunks per split) of the hidden dim: as many blocks as fit in
    one wave of the card, never a second, nearly empty wave."""
    chunks = f // _f_chunk(c)
    m_blocks = -(-m // (_ACC_ELEMS // c))
    want = max(1, min(chunks, _SMS // m_blocks))
    per = -(-chunks // want)
    return -(-chunks // per), per


def geglu_ff(x, proj_w, proj_b, out_w, out_b):
    """x [..., C] -> [..., C]: the reference GEGLU FeedForward."""
    global launches
    c = x.shape[-1]
    f = out_w.shape[0]
    if (proj_w.dim() != 2 or tuple(proj_w.shape) != (c, 2 * f)
            or tuple(out_w.shape) != (f, c) or tuple(proj_b.shape) != (2 * f,)
            or tuple(out_b.shape) != (c,)):
        raise ValueError(f"geglu_ff: x [..., {c}], W1 {tuple(proj_w.shape)}, b1 "
                         f"{tuple(proj_b.shape)}, W2 {tuple(out_w.shape)}, b2 "
                         f"{tuple(out_b.shape)} do not match [C, 2F], [2F], [F, C], [C]")
    tensors = (x, proj_w, proj_b, out_w, out_b)
    lead = x.shape[:-1]
    x2d = x.reshape(-1, c)
    if all(t.device.type == "cpu" for t in tensors):
        return geglu_ff_plain(x2d, proj_w, proj_b, out_w, out_b).reshape(*lead, c)
    if any(t.device.type != "cuda" or t.device != x.device for t in tensors):
        raise ValueError("geglu_ff: tensors must share one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != x.dtype
                                                              for t in tensors):
        raise TypeError(f"geglu_ff: x and the weights must all be float32 or all "
                        f"bfloat16, got {[t.dtype for t in tensors]}")
    if c not in KERNEL_WIDTHS or f == 0 or f % _f_chunk(c):
        raise NotImplementedError(
            f"geglu_ff: no CUDA kernel for C={c}, F={f} (C in {KERNEL_WIDTHS}, F a "
            f"multiple of 2048 / (20480 / C))")
    x2d = x2d.contiguous()
    if not all(t.is_contiguous() for t in tensors[1:]):
        raise ValueError("geglu_ff: the weights must be contiguous")
    m = x2d.shape[0]
    out = torch.empty((m, c), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, c)
    splits, per = _split_f(m, c, f)
    part = (torch.empty((splits, m, c), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    rc = _build.lib().vt_geglu_ff(
        x2d.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(), out_w.data_ptr(),
        out_b.data_ptr(), out.data_ptr(), part.data_ptr() if part is not None else None,
        m, c, f, splits, per, int(x.dtype == torch.bfloat16), _build.stream_handle(x.device))
    _build.check(rc, "geglu_ff")
    launches += 1
    return out.reshape(*lead, c)
