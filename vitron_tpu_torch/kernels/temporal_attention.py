"""Per-pixel frame attention: the hand CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel
`vitron_tpu/kernels/temporal_attention.py::_kernel` (:45, pallas_call at :97
in `_fwd` :87, entry `frame_attention` :150):

    q, k, v [B, F, N, H*D] -> o [B, F, N, H*D]
    for each (b, pixel n, head h): o = softmax_f((q @ k^T) * scale) @ v

with float32 scores, an exact float32 softmax over the F frames and o in
v's dtype: the video UNet's TemporalTransformer attends over the frame axis
independently at every pixel (`unet_sd_video._temporal_mha`). The scale is
applied to the float32 scores, as the JAX package's einsum form does (its
Pallas entry folded it into q first).

The kernel is `csrc/temporal_attention.cu`: each warp walks a stream of
(b, n, h) items, reading the [B, F, N, H*D] layout in place with 16-byte
copies into shared memory (in the input type; the next item's q and k in
flight while the current one computes); lanes own register tiles of
(key, query) scores, a query row for the softmax and (query, depth) tiles
of the product with v, so F <= 32 and D in {32, 64, 128}; other shapes on
the card raise. The JAX gate `usable` (TPU backend, bf16,
`VITRON_TATTN=fused`, a pixel count its block tiling divides) recorded TPU
facts, as B3's and B8's gates did; here every CUDA call launches the kernel,
in float32 and bfloat16. Where JAX's default bf16 path rounds the
probabilities to bf16 and normalises after the product with v
(`unet_sd_video.py:237-247`), the kernel's softmax is exact in float32: the
two differ by bf16 rounding. `frame_attention` launches it for CUDA tensors
and takes the plain version only for CPU tensors. `launches` counts kernel
launches. Only the forward is ported: the JAX backward (an einsum VJP,
:132-134) comes with training.
"""
from __future__ import annotations

import torch

from vitron_tpu_torch.kernels import _build

launches = 0  # kernel launches since the last reset (CPU calls do not count)

MAX_FRAMES = 32
HEAD_DIMS = (32, 64, 128)


def frame_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                          scale: float) -> torch.Tensor:
    """Plain PyTorch version: the JAX einsum form `_xla` (:111-120) with the
    kernel's arithmetic (float32 scores and softmax, o cast to v's dtype)."""
    b, f, n, hc = q.shape
    d = hc // heads
    f32 = torch.float32
    q5, k5, v5 = (t.to(f32).reshape(b, f, n, heads, d) for t in (q, k, v))
    sim = torch.einsum("bfnhd,bgnhd->bnhfg", q5, k5) * scale
    attn = torch.softmax(sim, dim=-1)
    return torch.einsum("bnhfg,bgnhd->bfnhd", attn, v5).reshape(b, f, n, hc).to(v.dtype)


def frame_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    scale: float) -> torch.Tensor:
    """q/k/v [B, F, N, H*D] -> [B, F, N, H*D]: softmax over the frame axis
    per (pixel, head)."""
    global launches
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"frame_attention: q, k, v must be one [B, F, N, H*D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, f, n, hc = q.shape
    if heads <= 0 or hc % heads:
        raise ValueError(f"frame_attention: {hc} channels do not split into {heads} heads")
    d = hc // heads
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return frame_attention_plain(q, k, v, heads, scale)
    if any(t.device.type != "cuda" or t.device != q.device for t in (q, k, v)):
        raise ValueError("frame_attention: q, k and v must share one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"frame_attention: q, k, v must all be float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if f > MAX_FRAMES or d not in HEAD_DIMS:
        raise NotImplementedError(f"frame_attention: no CUDA kernel for F={f}, head dim {d} "
                                  f"(F <= {MAX_FRAMES}, D in {HEAD_DIMS})")
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel():
        rc = _build.lib().vt_frame_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, f, n, heads, d,
            float(scale), int(q.dtype == torch.bfloat16), _build.stream_handle(q.device))
        _build.check(rc, "frame_attention")
        launches += 1
    return out
