"""Ring attention: sequence-parallel attention over a mesh axis.

Port of `vitron_tpu/distributed/ring_attention.py`. The sequence is split
contiguously over the ranks of `axis_name`; each rank keeps its queries
while the K/V blocks travel round the ring, and the blocks' partial results
merge by their log-sum-exp: O(S/N) memory a rank, the exact result.

Each block is attended by `block_attend`: B2 with its LSE on CUDA tensors
(`kernels/flash_attention._forward(..., want_lse=True)`); on the CPU the
plain form of JAX's `_block_attend`. A block of an earlier shard runs
non-causal, this rank's own block causal at offset 0, and a later block is
fully masked and skipped (JAX computes and masks it to zero: the same
result). K/V keep their own KV heads (B2 takes the GQA; JAX repeats them
first) and rotate to the next rank by `batch_isend_irecv`, double-buffered:
the next block's transfer is posted before this block is attended, and
every rank posts its send and receive whether or not it skips the block.
Blocks merge in float32 (`merge`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from vitron_tpu_torch.core.mesh import all_gather

NEG_INF = torch.finfo(torch.float32).min


def _block_plain(q, k, v, scale: float, causal: bool):
    """JAX's `_block_attend` with the queries and keys at the same offset:
    float32 logits, a guarded row max, p rounded to v's dtype for p @ v ->
    (out normalised, float32 [B, S, N, D]; lse [B, N, S])."""
    b, s, n, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, n // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32) * scale
    if causal:
        keep = torch.arange(s, device=q.device)[:, None] >= torch.arange(t, device=q.device)
        logits = torch.where(keep, logits, NEG_INF)
    m = torch.clamp(logits.amax(dim=-1, keepdim=True), min=-1e30)
    p = torch.exp(logits - m)
    p = torch.where(logits <= NEG_INF / 2, 0.0, p)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype), v).to(torch.float32)
    o = o / l.permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(l)).reshape(b, n, s)
    return o.reshape(b, s, n, d), lse


def block_attend(q, k, v, scale: float, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One ring block: q [B, S, N, D] against k/v [B, T, K, D] at the same
    offset -> (out [B, S, N, D], lse [B, N, S] float32)."""
    if q.device.type == "cuda":
        from vitron_tpu_torch.kernels import flash_attention as fa

        return fa._forward(q.contiguous(), k.contiguous(), v.contiguous(), None, 0, scale,
                           causal, None, True)
    return _block_plain(q, k, v, scale, causal)


def merge(acc: Optional[Tuple[torch.Tensor, torch.Tensor]], out: torch.Tensor,
          lse: torch.Tensor):
    """Fold one block (out, lse) into the running (out float32, lse)."""
    out = out.to(torch.float32)
    if acc is None:
        return out, lse
    o_acc, lse_acc = acc
    new = torch.logaddexp(lse_acc, lse)
    w_acc = torch.exp(lse_acc - new).permute(0, 2, 1)[..., None]
    w_blk = torch.exp(lse - new).permute(0, 2, 1)[..., None]
    return o_acc * w_acc + out * w_blk, new


def _rotate(tensors, group, size: int, my: int):
    """Post the sends of `tensors` to the next rank and the receives of the
    previous rank's into new buffers -> (buffers, requests)."""
    nxt = dist.get_global_rank(group, (my + 1) % size)
    prv = dist.get_global_rank(group, (my - 1) % size)
    bufs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, buf in zip(tensors, bufs):
        ops.append(dist.P2POp(dist.isend, t, nxt, group=group))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group=group))
    return bufs, dist.batch_isend_irecv(ops)


def ring_attention_shard(q, k, v, group, scale: Optional[float] = None,
                         causal: bool = True) -> torch.Tensor:
    """Per-rank body: q/k/v [B, S_local, N|K, D], this rank's contiguous
    shard of the sequence over `group`; -> its attention output."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    size = dist.get_world_size(group)
    my = dist.get_group_rank(group, dist.get_rank())
    acc = None
    kv = [k.contiguous(), v.contiguous()]
    for i in range(size):
        reqs = None
        if i + 1 < size:
            nxt, reqs = _rotate(kv, group, size, my)
        src = (my - i) % size
        if not causal or src < my:
            acc = merge(acc, *block_attend(q, kv[0], kv[1], scale, False))
        elif src == my:
            acc = merge(acc, *block_attend(q, kv[0], kv[1], scale, True))
        if reqs is not None:
            for r in reqs:
                r.wait()
            kv = nxt
    return acc[0].to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "context", scale: Optional[float] = None,
                   causal: bool = True) -> torch.Tensor:
    """Full-array entry: q [B, S, N, D], k/v [B, S, K, D], the same on
    every rank, with S divisible by the axis; each rank runs the ring on
    its contiguous shard and the outputs are gathered along the sequence."""
    group = mesh.group(axis_name)
    n, my = mesh.shape[axis_name], mesh.index(axis_name)
    s = q.shape[1]
    if s % n:
        raise ValueError(f"ring attention: sequence {s} not divisible by {axis_name}={n}")
    sl = s // n
    part = [t[:, my * sl:(my + 1) * sl] for t in (q, k, v)]
    out = ring_attention_shard(*part, group, scale=scale, causal=causal)
    return all_gather(out, group, dim=1)
