"""Flash-attention forward: the hand CUDA kernel and its plain twin.

Replaces the forward of the Pallas TPU kernel
`vitron_tpu/kernels/flash_attention.py::_flash_kernel` (:92, launched by
`_flash_forward` :179). The kernel is `csrc/flash_attention_fwd.cu`; its
note says what bounds it on the H100 and how the design answers that.

Semantics are the JAX kernel's, in key-slot space (module docstring of the
JAX file): q [B,S,N,D], k/v [B,T,K,D]; query i sits at slot q_offset + i and
sees key slot j iff (not causal or q_offset + i >= j) and kv_mask[b, j];
GQA maps query head n to kv head n // (N // K). A query row that sees no
valid key comes out as zeros (the kernel's finalize acc / max(l, 1e-30)),
not as the mean of v that `reference_attention` gives.

`flash_attention` launches the kernel for CUDA tensors (float32/bfloat16,
D in KERNEL_HEAD_DIMS: 64/128 for the LLM, 40/80/160 for the SD UNet and
512 for the VAE's single-head mid attention) and takes the plain version
only for CPU tensors; other head dims raise. The backward (B5) is not
ported. `launches` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

NEG_INF = torch.finfo(torch.float32).min
KERNEL_HEAD_DIMS = (40, 64, 80, 128, 160, 512)


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
                          softmax_shift=None):
    """Plain PyTorch version of the kernel: float32 logits and softmax,
    exp(logit - rowmax) (or exp(min(logit - shift, 60)) with softmax_shift)
    over visible slots, out = (p @ v) / max(sum p, 1e-30) -- zeros for a row
    with no visible key."""
    b, s, n, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    groups = n // kv_heads
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qq = q.to(torch.float32).reshape(b, s, kv_heads, groups, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qq, k.to(torch.float32)) * scale
    mask = _visible(b, s, t, q.device, kv_mask, q_offset, causal)
    logits = torch.where(mask, logits, NEG_INF)
    if softmax_shift is None:
        p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    else:
        p = torch.exp(torch.clamp(logits - softmax_shift, max=60.0))
    p = torch.where(mask, p, 0.0)
    denom = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32)) / denom.permute(
        0, 3, 1, 2, 4)
    return out.reshape(b, s, n, d).to(q.dtype)


def flash_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None, q_offset: int = 0,
                    scale: Optional[float] = None, causal: bool = True,
                    softmax_shift: Optional[float] = None) -> torch.Tensor:
    """Flash attention forward; see the module docstring for the mask
    semantics. q [B,S,N,D]; k/v [B,T,K,D]; kv_mask [B,T] bool; q_offset a
    Python int (slot of q[0])."""
    global launches
    b, s, n, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match [B,S,N,D] / [B,T,K,D]")
    t, kv_heads = k.shape[1], k.shape[2]
    if n % kv_heads:
        raise ValueError(f"flash_attention: {n} query heads not a multiple of {kv_heads}")
    if kv_mask is not None and tuple(kv_mask.shape) != (b, t):
        raise ValueError(f"flash_attention: kv_mask {tuple(kv_mask.shape)} != ({b}, {t})")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    tensors = [q, k, v] + ([kv_mask] if kv_mask is not None else [])
    if all(x.device.type == "cpu" for x in tensors):
        return flash_attention_plain(q, k, v, kv_mask, q_offset, scale, causal, softmax_shift)
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
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    rc = _build.lib().vt_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_mask.data_ptr() if kv_mask is not None else None, out.data_ptr(),
        b, s, t, n, kv_heads, d, int(q_offset), float(scale), int(causal),
        int(softmax_shift is not None), float(softmax_shift or 0.0),
        int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
    _build.check(rc, "flash_attention")
    launches += 1
    return out
