"""Flash attention: the hand CUDA kernels (forward B2, backward B5a/B5b)
and their plain twins.

The forward replaces `vitron_tpu/kernels/flash_attention.py::_flash_kernel`
(:92, launched by `_flash_forward` :179); the backward replaces
`_flash_bwd_kv_kernel` (:302, dK/dV) and `_flash_bwd_q_kernel` (:343, dQ),
launched by `_flash_backward` :379. The kernels are
`csrc/flash_attention_fwd.cu` and `csrc/flash_attention_bwd.cu`; their
notes say what bounds them on the H100 and how the designs answer that.

Semantics are the JAX kernel's, in key-slot space (module docstring of the
JAX file): q [B,S,N,D], k/v [B,T,K,D]; query i sits at slot q_offset + i and
sees key slot j iff (not causal or q_offset + i >= j) and kv_mask[b, j];
q_offset is a Python int or a [1] int64 tensor on q's device, which the
forward kernel reads on the device (the JAX kernel's scalar-prefetch
offset), so that a captured CUDA graph can replay a cached window at a slot
that moves with the data (`llama.decode_step`'s verify window);
GQA maps query head n to kv head n // (N // K). A query row that sees no
valid key comes out as zeros (the kernel's finalize acc / max(l, 1e-30)),
not as the mean of v that `reference_attention` gives, and gets zero
gradients.

`flash_attention` launches the forward kernel for CUDA tensors
(float32/bfloat16, D in KERNEL_HEAD_DIMS: 64/128 for the LLM, 40/80/160 for
the SD UNet and 512 for the VAE's single-head mid attention) and takes the
plain version only for CPU tensors; other head dims raise. When a gradient
is wanted (grad mode on and q, k or v requiring grad) it goes through
`FlashAttention`, a `torch.autograd.Function` in place of the JAX
`custom_vjp` (:473-498): the forward also writes the per-row log-sum-exp,
and the backward launches B5a and B5b on the card (bf16 on the tensor
cores at D 40/64/80/128/160; float32 on FMA pipes at D 64/128, other
float32 head dims raise) or runs `flash_attention_bwd_plain` on the CPU.
`launches`, `bwd_kv_launches` and `bwd_q_launches` count the launches of
the three kernels.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # forward (B2) launches since the last reset (CPU calls do not count)
bwd_kv_launches = 0  # B5a launches
bwd_q_launches = 0  # B5b launches

NEG_INF = torch.finfo(torch.float32).min
KERNEL_HEAD_DIMS = (40, 64, 80, 128, 160, 512)
BWD_HEAD_DIMS = (40, 64, 80, 128, 160)  # the LLM's 64/128, the SD UNet's 40/80/160
BWD_F32_HEAD_DIMS = (64, 128)  # float32 (no main path: the UNet casts q/k/v to bf16)


def reference_attention(q, k, v, kv_mask=None, q_offset=None, scale=None, causal=True):
    """Port of the JAX `reference_attention`: plain softmax, logits in the
    input dtype (a fully masked row gives the mean of v). q_offset defaults
    to T - S."""
    b, s, n, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    groups = n // kv_heads
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if q_offset is None:
        q_offset = t - s
    qq = q.reshape(b, s, kv_heads, groups, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qq, k).to(torch.float32) * scale
    mask = _visible(b, s, t, q.device, kv_mask, q_offset, causal)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, n, d)


def _visible(b, s, t, device, kv_mask, q_offset, causal):
    """[B|1, 1, 1, S, T] bool: which key slots each query row may see."""
    if causal:
        q_pos = q_offset + torch.arange(s, device=device)[:, None]
        mask = (q_pos >= torch.arange(t, device=device)[None, :])[None, None, None]
    else:
        mask = torch.ones((1, 1, 1, s, t), dtype=torch.bool, device=device)
    if kv_mask is not None:
        mask = mask & kv_mask[:, None, None, None, :]
    return mask


def flash_attention_plain(q, k, v, kv_mask=None, q_offset=0, scale=None, causal=True,
                          softmax_shift=None, return_lse=False):
    """Plain PyTorch version of the forward kernel: float32 logits and
    softmax, exp(logit - rowmax) (or exp(min(logit - shift, 60)) with
    softmax_shift) over visible slots, out = (p @ v) / max(sum p, 1e-30) --
    zeros for a row with no visible key. As the kernel (TPU and CUDA) does,
    q * scale is rounded to q's dtype before the logits and p to v's dtype
    before p @ v, while the sum adds the unrounded float32 p (for float32
    both roundings are the identity).

    return_lse=True gives (out, lse) with lse [B, N, S] float32 = (rowmax, or
    the shift) + log(max(sum p, 1e-30))."""
    b, s, n, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    groups = n // kv_heads
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qq = _scaled_q(q, scale).reshape(b, s, kv_heads, groups, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qq, k.to(torch.float32))
    mask = _visible(b, s, t, q.device, kv_mask, q_offset, causal)
    logits = torch.where(mask, logits, NEG_INF)
    if softmax_shift is None:
        base = logits.amax(dim=-1, keepdim=True)
        p = torch.exp(logits - base)
    else:
        base = torch.full((), softmax_shift, dtype=torch.float32, device=q.device)
        p = torch.exp(torch.clamp(logits - softmax_shift, max=60.0))
    p = torch.where(mask, p, 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    pv = p.to(v.dtype).to(torch.float32)
    out = torch.einsum("bkgst,btkd->bskgd", pv, v.to(torch.float32)) / denom.permute(
        0, 3, 1, 2, 4)
    out = out.reshape(b, s, n, d).to(q.dtype)
    if not return_lse:
        return out
    lse = (base + torch.log(denom)).reshape(b, n, s)
    return out, lse


def _scaled_q(q, scale):
    """q * scale in float32, rounded to q's dtype (the JAX `_scaled_q`)."""
    return (q.to(torch.float32) * scale).to(q.dtype).to(torch.float32)


def _bwd_plain_common(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout):
    """(p, ds, dout) in float32 [B,K,G,S,T] / [B,S,K,G,D], p and ds rounded
    to the input dtype: p = exp(round(q * scale) . k - lse) over visible
    slots, delta = rowsum(dout * out), ds = p (dout . v - delta)."""
    b, s, n, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    groups = n // kv_heads
    dt, f32 = q.dtype, torch.float32
    do = dout.to(dt).to(f32).reshape(b, s, kv_heads, groups, d)
    delta = (do * out.to(f32).reshape(b, s, kv_heads, groups, d)).sum(-1)  # [b, s, k, g]
    qs = _scaled_q(q, scale).reshape(b, s, kv_heads, groups, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qs, k.to(f32))
    mask = _visible(b, s, t, q.device, kv_mask, q_offset, causal)
    lse5 = lse.reshape(b, kv_heads, groups, s)[..., None]
    p = torch.where(mask, torch.exp(torch.where(mask, logits - lse5, NEG_INF)), 0.0)
    dp = torch.einsum("bskgd,btkd->bkgst", do, v.to(f32))
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    return p.to(dt).to(f32), ds.to(dt).to(f32), do


def flash_attention_bwd_kv_plain(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout):
    """Plain version of B5a: -> (dk, dv), summed over the GQA groups in float32."""
    b, s, n, d = q.shape
    kv_heads = k.shape[2]
    p, ds, do = _bwd_plain_common(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dk = torch.einsum("bkgst,bskgd->btkd", ds,
                      q.to(torch.float32).reshape(b, s, kv_heads, n // kv_heads, d)) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_q_plain(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout):
    """Plain version of B5b: -> dq."""
    b, s, n, d = q.shape
    _, ds, _ = _bwd_plain_common(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(torch.float32)).reshape(b, s, n, d)
    return (dq * scale).to(q.dtype)


def flash_attention_bwd_plain(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout):
    """Plain PyTorch version of the backward (`_flash_backward` :379): p
    recomputed from the LSE, p and ds rounded to the input dtype before the
    dV, dK and dQ products, sums in float32. -> (dq, dk, dv)."""
    dk, dv = flash_attention_bwd_kv_plain(q, k, v, kv_mask, q_offset, scale, causal, out, lse,
                                          dout)
    return (flash_attention_bwd_q_plain(q, k, v, kv_mask, q_offset, scale, causal, out, lse,
                                        dout), dk, dv)


def _device_offset(q_offset) -> bool:
    return torch.is_tensor(q_offset)


def _check(q, k, v, kv_mask, q_offset):
    """Validate shapes; -> True for CPU tensors (the plain path), False for
    one CUDA device (the kernels), raise otherwise."""
    b, s, n, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match [B,S,N,D] / [B,T,K,D]")
    t, kv_heads = k.shape[1], k.shape[2]
    if n % kv_heads:
        raise ValueError(f"flash_attention: {n} query heads not a multiple of {kv_heads}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, t):
        raise ValueError(f"flash_attention: kv_mask {tuple(kv_mask.shape)} != ({b}, {t})")
    if _device_offset(q_offset) and (q_offset.dtype != torch.int64 or q_offset.numel() != 1):
        raise TypeError(f"flash_attention: a tensor q_offset must be one int64, got "
                        f"{q_offset.dtype} {tuple(q_offset.shape)}")
    tensors = ([q, k, v] + ([kv_mask] if kv_mask is not None else [])
               + ([q_offset] if _device_offset(q_offset) else []))
    if all(x.device.type == "cpu" for x in tensors):
        return True
    if any(x.device.type != "cuda" or x.device != q.device for x in tensors):
        raise ValueError("flash_attention: tensors must share one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q/k/v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in KERNEL_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention: head dim {d} has no CUDA kernel (it takes "
            f"{KERNEL_HEAD_DIMS})")
    if kv_mask is not None and kv_mask.dtype != torch.bool:
        raise TypeError(f"flash_attention: kv_mask dtype {kv_mask.dtype} is not bool")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("flash_attention: q, k, v and kv_mask must be contiguous")
    if not _device_offset(q_offset) and q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    return False


def _forward(q, k, v, kv_mask, q_offset, scale, causal, softmax_shift, want_lse):
    """-> (out, lse or None) from the plain version (CPU) or the kernel."""
    global launches
    if _check(q, k, v, kv_mask, q_offset):
        if want_lse:
            return flash_attention_plain(q, k, v, kv_mask, q_offset, scale, causal,
                                         softmax_shift, return_lse=True)
        return flash_attention_plain(q, k, v, kv_mask, q_offset, scale, causal,
                                     softmax_shift), None
    b, s, n, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, n, s), dtype=torch.float32, device=q.device) if want_lse else None
    if out.numel() == 0:
        return out, lse
    if q.dtype == torch.bfloat16:  # the tensor-core kernel copies 16 bytes at a time
        q, k, v = (_build.aligned16(x) for x in (q, k, v))
    dev_off = _device_offset(q_offset)
    rc = _build.lib().vt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None, out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, s, t, n, kv_heads, d, 0 if dev_off else int(q_offset),
        q_offset.data_ptr() if dev_off else None, float(scale), int(causal),
        int(softmax_shift is not None), float(softmax_shift or 0.0),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
    _build.check(rc, "flash_attention")
    launches += 1
    return out, lse


def _bwd_args(q, k, v, kv_mask, q_offset, out, lse, dout) -> bool:
    """Validate the backward kernels' inputs; -> True for CPU tensors (the
    plain path), False for the kernels (CUDA, a head dim of BWD_HEAD_DIMS,
    contiguous)."""
    if _check(q, k, v, kv_mask, q_offset):
        return True
    _check_bwd_head_dim(q)
    b, s, n, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape or tuple(lse.shape) != (b, n, s):
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if lse.dtype != torch.float32 or dout.dtype != q.dtype or out.dtype != q.dtype:
        raise TypeError("flash_attention backward: lse must be float32, out and dout q's dtype")
    if not all(x.is_contiguous() and x.device == q.device for x in (out, lse, dout)):
        raise ValueError("flash_attention backward: out, lse and dout must be contiguous "
                         "and on q's device")
    return False


def _check_bwd_head_dim(q):
    d = q.shape[-1]
    if d not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention backward: head dim {d} has no CUDA kernel (it takes "
            f"{BWD_HEAD_DIMS})")
    if q.dtype == torch.float32 and d not in BWD_F32_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention backward: float32 at head dim {d} has no CUDA kernel (float32 "
            f"takes {BWD_F32_HEAD_DIMS}, bfloat16 {BWD_HEAD_DIMS})")


def _delta(out, dout):
    """rowsum(dout * out) in float32, [B, N, S] (the JAX `delta` :395)."""
    return (dout.to(torch.float32) * out.to(torch.float32)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_kv(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout,
                           delta=None):
    """B5a: -> (dk, dv) [B,T,K,D] in k's dtype (the plain version for CPU
    tensors)."""
    global bwd_kv_launches
    if _bwd_args(q, k, v, kv_mask, q_offset, out, lse, dout):
        return flash_attention_bwd_kv_plain(q, k, v, kv_mask, q_offset, scale, causal, out, lse,
                                            dout)
    b, s, n, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dk.zero_(), dv.zero_()
    if delta is None:
        delta = _delta(out, dout)
    bf16 = q.dtype == torch.bfloat16
    qs = None
    if bf16:  # the tensor-core kernel copies 16 bytes at a time; qs takes round(q * scale)
        q, k, v, dout = (_build.aligned16(x) for x in (q, k, v, dout))
        qs = torch.empty_like(q)
    rc = _build.lib().vt_flash_attention_bwd_kv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), kv_mask.data_ptr() if kv_mask is not None else None,
        qs.data_ptr() if qs is not None else None, dk.data_ptr(), dv.data_ptr(), b, s, t, n,
        kv_heads, d, int(q_offset), float(scale), int(causal), int(bf16),
        _build.stream_handle(q.device))
    _build.check(rc, "flash_attention backward (dK, dV)")
    bwd_kv_launches += 1
    return dk, dv


def flash_attention_bwd_q(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout,
                          delta=None):
    """B5b: -> dq [B,S,N,D] in q's dtype (the plain version for CPU
    tensors)."""
    global bwd_q_launches
    if _bwd_args(q, k, v, kv_mask, q_offset, out, lse, dout):
        return flash_attention_bwd_q_plain(q, k, v, kv_mask, q_offset, scale, causal, out, lse,
                                           dout)
    b, s, n, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_()
    if delta is None:
        delta = _delta(out, dout)
    if q.dtype == torch.bfloat16:
        q, k, v, dout = (_build.aligned16(x) for x in (q, k, v, dout))
    rc = _build.lib().vt_flash_attention_bwd_q(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), kv_mask.data_ptr() if kv_mask is not None else None,
        dq.data_ptr(), b, s, t, n, kv_heads, d, int(q_offset), float(scale), int(causal),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
    _build.check(rc, "flash_attention backward (dQ)")
    bwd_q_launches += 1
    return dq


def flash_attention_bwd(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout):
    """The backward -> (dq, dk, dv): B5a then B5b on the card, sharing one
    delta; their plain versions for CPU tensors."""
    dout = dout.contiguous()
    delta = _delta(out, dout) if q.device.type == "cuda" else None
    dk, dv = flash_attention_bwd_kv(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout,
                                    delta)
    dq = flash_attention_bwd_q(q, k, v, kv_mask, q_offset, scale, causal, out, lse, dout, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient: saves out and the LSE, and sends
    the backward to B5a/B5b (card) or the plain backward (CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, q_offset, scale, causal, softmax_shift):
        if q.device.type == "cuda":  # fail before the forward, not in the backward
            _check_bwd_head_dim(q)
        out, lse = _forward(q, k, v, kv_mask, q_offset, scale, causal, softmax_shift, True)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.args = (q_offset, scale, causal)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        q_offset, scale, causal = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, kv_mask, q_offset, scale, causal, out, lse,
                                         dout)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                    q_offset: Union[int, torch.Tensor] = 0, scale: Optional[float] = None,
                    causal: bool = True, softmax_shift: Optional[float] = None) -> torch.Tensor:
    """Flash attention; see the module docstring for the mask semantics and
    the gradient. q [B,S,N,D]; k/v [B,T,K,D]; kv_mask [B,T] bool; q_offset
    the slot of q[0], a Python int or a [1] int64 tensor on q's device (the
    forward only: a gradient needs a host int)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if _device_offset(q_offset):
            raise TypeError("flash_attention: the backward takes a host int q_offset")
        return FlashAttention.apply(q, k, v, kv_mask, q_offset, float(scale), causal,
                                    softmax_shift)
    return _forward(q, k, v, kv_mask, q_offset, scale, causal, softmax_shift, False)[0]
