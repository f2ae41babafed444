"""Paged KV cache: block-pooled KV storage for multi-request serving.

Port of `vitron_tpu/models/llm/paged_cache.py`:

- one global block pool per layer: k/v [L, num_blocks, block_size, KV, D],
  updated IN PLACE (`index_put_`; the JAX package rebinds the pool to the
  result of a functional `.at[].set`, which here would detach every
  captured graph that reads the pool);
- each sequence owns a host-managed list of block ids (the block table);
  sequences grow by appending blocks, finish by returning them to the free
  list — no compaction, no per-request preallocation of max_len;
- decode attention gathers each sequence's blocks with one index (a torch
  gather) and masks by true length: a batch of ragged sequences, one
  program for a (steps, batch, max_blocks, sampled) bucket.

Everything on the device has a static shape; raggedness lives in the int64
block tables and lengths. `PagedServer.step_n` decodes n tokens of every
active sequence as one `runtime/graphs.Chunk`: a CUDA graph captured per
bucket and replayed on the card, the same steps run eagerly on the CPU. The
attention of `decode_step_gathered` is plain torch einsums, as it is XLA
einsums in the JAX package (no Pallas kernel); its projections go through
the int4 kernel (B1) at M = the active batch.

On a mesh (`runtime/sharded_serving.install_mesh`) the pool holds this
rank's KV heads (the head axis on `tensor`, JAX's `paged_pool_shardings`)
and each decode layer gathers its fsdp blocks and runs Megatron-split, as
`llama.forward` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels.quantization import matmul_maybe_quantized as _mm
from vitron_tpu_torch.kernels.quantization import promote_int4
from vitron_tpu_torch.core.mesh import gather_params
from vitron_tpu_torch.distributed import tensor_parallel as tp
from vitron_tpu_torch.models.llm.llama import (KVCache, LlamaConfig, _layer_params, apply_rope,
                                               forward_tokens, local_kv_heads, materialize_layer,
                                               rms_norm, rope_cos_sin)
from vitron_tpu_torch.runtime.graphs import Chunk
from vitron_tpu_torch.runtime.telemetry import ProgramCache


@dataclasses.dataclass
class PagedPool:
    """Device block pool + host allocator."""

    k: torch.Tensor          # [L, num_blocks, block_size, KV, D]
    v: torch.Tensor
    block_size: int
    free: List[int]

    @staticmethod
    def create(cfg: LlamaConfig, num_blocks: int, block_size: int = 16,
               device=None, kv_heads: Optional[int] = None) -> "PagedPool":
        """kv_heads: this rank's KV heads on a mesh (`llama.local_kv_heads`)."""
        shape = (cfg.num_layers, num_blocks, block_size, kv_heads or cfg.num_kv_heads,
                 cfg.head_dim)
        return PagedPool(
            k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            block_size=block_size,
            free=list(range(num_blocks - 1, -1, -1)),
        )

    def alloc(self) -> int:
        if not self.free:
            raise RuntimeError("paged KV pool exhausted")
        return self.free.pop()

    def release(self, blocks: List[int]) -> None:
        self.free.extend(blocks)


@dataclasses.dataclass
class PagedSequence:
    """Host bookkeeping for one request."""

    blocks: List[int]
    length: int = 0

    def ensure_capacity(self, pool: PagedPool, new_tokens: int) -> None:
        need = self.length + new_tokens
        while len(self.blocks) * pool.block_size < need:
            self.blocks.append(pool.alloc())


def write_tokens(pool: PagedPool, seq: PagedSequence,
                 k_new: torch.Tensor, v_new: torch.Tensor) -> PagedPool:
    """Append [L, S, KV, D] keys/values to a sequence's blocks, in place
    (general unaligned path: one copy per touched block; PagedServer uses
    the single-scatter paths below instead). Returns the same pool."""
    s = k_new.shape[1]
    seq.ensure_capacity(pool, s)
    bs = pool.block_size
    pos = seq.length
    off = 0
    while off < s:
        blk_idx = (pos + off) // bs
        blk_off = (pos + off) % bs
        take = min(bs - blk_off, s - off)
        blk = seq.blocks[blk_idx]
        pool.k[:, blk, blk_off:blk_off + take] = k_new[:, off:off + take]
        pool.v[:, blk, blk_off:blk_off + take] = v_new[:, off:off + take]
        off += take
    seq.length += s
    return pool


def gather_kv(pool: PagedPool, table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """table: [B, max_blocks] int64 (pad with 0) ->
    k/v [L, B, max_blocks*block_size, KV, D]."""
    k = pool.k[:, table]  # [L, B, MB, bs, KV, D]
    v = pool.v[:, table]
    l, b, mb, bs, kv, d = k.shape
    return k.reshape(l, b, mb * bs, kv, d), v.reshape(l, b, mb * bs, kv, d)


def paged_decode_step(params: Dict[str, Any], cfg: LlamaConfig, token_embeds: torch.Tensor,
                      positions: torch.Tensor, pool: PagedPool, table: torch.Tensor,
                      lengths: torch.Tensor):
    """One decode step over a ragged batch. token_embeds [B, 1, H], positions
    [B, 1], table [B, max_blocks], lengths [B] (INCLUDING the new token). The
    new token's K/V are returned per layer for the caller to scatter.
    Returns (logits [B, vocab], new_k, new_v [L, B, KV, D])."""
    k_all, v_all = gather_kv(pool, table)
    return decode_step_gathered(params, cfg, token_embeds, positions, k_all, v_all, lengths)


def decode_step_gathered(params: Dict[str, Any], cfg: LlamaConfig, token_embeds: torch.Tensor,
                         positions: torch.Tensor, k_all: torch.Tensor, v_all: torch.Tensor,
                         lengths: torch.Tensor):
    """Decode step on PRE-GATHERED per-sequence KV k_all/v_all
    [L, B, T, KV, D]. step_n gathers the block table once per n-token chunk
    and carries the dense view through its steps."""
    b = token_embeds.shape[0]
    x = token_embeds.to(cfg.compute_dtype)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    t = k_all.shape[2]
    key_pos = torch.arange(t, device=x.device)[None, :]
    valid = key_pos < (lengths[:, None] - 1)   # existing tokens only
    kv_heads = k_all.shape[3]  # this rank's on a mesh
    groups = cfg.num_heads // cfg.num_kv_heads
    neg = torch.finfo(torch.float32).min
    layers = params["layers"]
    k_news, v_news = [], []
    for li in range(cfg.num_layers):
        lp, attn_group, mlp_group = materialize_layer(_layer_params(layers, li), cfg)
        layer_k, layer_v = k_all[li], v_all[li]
        xn = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q = _mm(xn, lp["wq"]).reshape(b, 1, kv_heads * groups, cfg.head_dim)
        k_new = _mm(xn, lp["wk"]).reshape(b, 1, kv_heads, cfg.head_dim)
        v_new = _mm(xn, lp["wv"]).reshape(b, 1, kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
        # attend: gathered history (masked) + the new token itself
        qg = q.reshape(b, 1, kv_heads, groups, cfg.head_dim)
        hist = torch.einsum("bskgd,btkd->bkgst", qg, layer_k.to(q.dtype))
        hist = hist.to(torch.float32) * scale
        hist = torch.where(valid[:, None, None, None, :], hist, neg)
        self_logit = torch.einsum("bskgd,bskd->bkgs", qg, k_new.to(q.dtype))
        self_logit = self_logit.to(torch.float32)[..., None] * scale
        logits = torch.cat([hist, self_logit], dim=-1)
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        p_hist, p_self = probs[..., :t], probs[..., t:]
        out = torch.einsum("bkgst,btkd->bskgd", p_hist, layer_v.to(q.dtype))
        out = out + torch.einsum("bkgs,bskd->bskgd", p_self[..., 0], v_new)
        x = x + tp.row_linear(out.reshape(b, 1, -1), lp["wo"], attn_group)
        xn = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        x = x + tp.row_linear(F.silu(_mm(xn, lp["gate"])) * _mm(xn, lp["up"]), lp["down"],
                              mlp_group)
        k_news.append(k_new[:, 0])
        v_news.append(v_new[:, 0])
    x = rms_norm(x, gather_params(params["final_norm"]), cfg.rms_norm_eps)
    logits = tp.linear(x[:, 0], params["lm_head"]).to(torch.float32)
    return logits, torch.stack(k_news), torch.stack(v_news)


def sample_token_batched(logits: torch.Tensor, temps: torch.Tensor, top_ps: torch.Tensor,
                         greedy: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-row sampling for co-batched decode: logits [B, V] with per-row
    temperature/top_p/greedy and one uniform u [B] in [0, 1) a row ->
    [B] int64. Rows with greedy=True (or temperature <= 0) take argmax;
    others nucleus-sample by the inverse CDF of their uniform (the top-1
    token is always kept): one program serves a mixed batch, and the same
    uniforms give the same tokens, eager or replayed."""
    greedy = greedy | (temps <= 0.0)
    safe_t = torch.where(greedy, torch.ones_like(temps), temps)
    scaled = logits / safe_t[:, None].to(logits.dtype)
    sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    # keep tokens until the cumulative probability exceeds top_p
    cutoff_idx = torch.sum(cum < top_ps[:, None], dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx.clamp(max=logits.shape[-1] - 1))
    masked = torch.where(scaled < cutoff, float("-inf"), scaled)
    cdf = torch.cumsum(torch.softmax(masked, dim=-1), dim=-1)
    sampled = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None].contiguous(), right=True)[:, 0]
    sampled = sampled.clamp(max=logits.shape[-1] - 1)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)


class _StepChunk:
    """n paged decode steps of a b-row batch whose block tables are
    max_blocks wide. Static buffers: `table` [b, max_blocks], `lengths`,
    `last` (the next input token), `temps`, `top_ps`, `greedy` [b], `u`
    [n, b] (sampled chunks) and `toks` [b, n]; the pool is the server's."""

    def __init__(self, srv: "PagedServer", n: int, b: int, max_blocks: int, sampled: bool):
        dev = srv.pool.k.device
        self.srv, self.n, self.b, self.sampled = srv, n, b, sampled
        z = lambda *shape, dtype=torch.int64: torch.zeros(shape, dtype=dtype, device=dev)  # noqa: E731
        self.table = z(b, max_blocks)
        self.lengths, self.last = z(b), z(b)
        self.temps = z(b, dtype=torch.float32)
        self.top_ps = z(b, dtype=torch.float32)
        self.greedy = z(b, dtype=torch.bool)
        self.u = z(n, b, dtype=torch.float32)
        self.toks = z(b, n)
        self.run = srv._graph_chunk(self._body, lambda: self._steps(1))

    def _steps(self, n: int) -> None:
        srv = self.srv
        cfg, bs, pool = srv.cfg, srv.pool.block_size, srv.pool
        # gather the ragged histories ONCE for the whole chunk; the steps
        # carry the dense view and mirror each new token into the pool so
        # the block tables stay authoritative
        k_all, v_all = gather_kv(pool, self.table)
        row = torch.arange(self.b, device=self.table.device)
        lengths, token = self.lengths.clone(), self.last.clone()
        for i in range(n):
            emb = srv.params["embed"][token][:, None]
            logits, k_new, v_new = decode_step_gathered(srv.decode_params, cfg, emb,
                                                        lengths[:, None], k_all, v_all,
                                                        lengths + 1)
            k_all[:, row, lengths] = k_new   # dense-view append
            v_all[:, row, lengths] = v_new
            wr_blocks = self.table[row, lengths // bs]   # pool mirror
            wr_offs = lengths % bs
            pool.k[:, wr_blocks, wr_offs] = k_new
            pool.v[:, wr_blocks, wr_offs] = v_new
            if self.sampled:
                nxt = sample_token_batched(logits, self.temps, self.top_ps, self.greedy,
                                           self.u[i])
            else:
                nxt = torch.argmax(logits, dim=-1)
            self.toks[:, i] = nxt
            lengths, token = lengths + 1, nxt

    def _body(self) -> None:
        self._steps(self.n)


class PagedServer:
    """Minimal continuous-batching loop: sequences join/leave between steps;
    each step decodes all active sequences in one program."""

    def __init__(self, params, cfg: LlamaConfig, num_blocks: int = 256,
                 block_size: int = 16, max_blocks_per_seq: int = 32, device=None):
        self.params = params
        # the decode chunks' tree: W4A8 leaves when VITRON_W4A8=1 (read here,
        # once), where the JAX package promotes inside its chunk program
        self.decode_params = promote_int4(params)
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else params["embed"].device
        self.kv_heads = local_kv_heads(params, cfg)
        self.pool = PagedPool.create(cfg, num_blocks, block_size, device=self.device,
                                     kv_heads=self.kv_heads)
        self.max_blocks = max_blocks_per_seq
        self.seqs: Dict[int, PagedSequence] = {}
        self.last_token: Dict[int, int] = {}
        self._next_id = 0
        # one graph per (steps, batch, max_blocks, sampled) bucket; bounded +
        # LRU so shape churn in a long-running server cannot accumulate
        # graphs (telemetry surfaces in /stats)
        self._chunk_fns = ProgramCache("paged-server-chunk", max_entries=16)
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()

    def _graph_chunk(self, body, warmup) -> Chunk:
        return Chunk(body, warmup, self.device, self._stream, self._pool)

    def _tensor(self, a, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.no_grad()
    def add_request(self, prompt_ids: List[int], chunk: Optional[int] = None) -> int:
        """Prefill a new sequence with ONE dense-cache forward (padded to a
        `chunk` bucket), then copy its K/V into pool blocks — a request costs
        one prefill + one scatter instead of len(prompt) decode steps."""
        sid = self._next_id
        self._next_id += 1
        seq = PagedSequence(blocks=[])
        self.seqs[sid] = seq
        n = len(prompt_ids) - 1  # the last prompt token decodes next step
        self.last_token[sid] = prompt_ids[-1]
        if n == 0:
            return sid
        bucket = chunk or n
        # round up to a whole number of blocks (>= n) so the dense K/V can be
        # reshaped straight into block rows
        bucket = self.pool.block_size * max(1, math.ceil(max(bucket, n) / self.pool.block_size))
        ids = torch.zeros((1, bucket), dtype=torch.int64, device=self.device)
        ids[0, :n] = self._tensor(prompt_ids[:n])
        mask = torch.zeros((1, bucket), dtype=torch.bool, device=self.device)
        mask[0, :n] = True
        pos = torch.arange(bucket, device=self.device)[None]
        cache = KVCache.create(self.cfg, 1, max_len=bucket, device=self.device,
                               kv_heads=self.kv_heads)
        forward_tokens(self.params, self.cfg, ids, positions=pos, attn_mask=mask, cache=cache)
        self._import_cache(sid, cache.k, cache.v, n)
        return sid

    def add_from_cache(self, cache_k: torch.Tensor, cache_v: torch.Tensor,
                       length: int, last_token: int) -> int:
        """Register a sequence whose prefill ran OUTSIDE the server (e.g. the
        multimodal spliced prefill in runtime/batching.py): copy the dense
        cache's first `length` slots into pool blocks. cache_k/v:
        [L, 1, T, KV, D] with real tokens right-padded at slots [0, length);
        `last_token` is the token the next decode step feeds."""
        sid = self._next_id
        self._next_id += 1
        self.seqs[sid] = PagedSequence(blocks=[])
        self.last_token[sid] = last_token
        if length > 0:
            self._import_cache(sid, cache_k, cache_v, length)
        return sid

    def _import_cache(self, sid: int, cache_k, cache_v, n: int) -> None:
        # scatter the dense K/V into pool blocks: prefill starts block-aligned
        # at 0, so the whole prompt lands in ONE index_put_ (padded tail rows
        # in the final block are dead weight masked out by `lengths` at read)
        seq = self.seqs[sid]
        bs = self.pool.block_size
        seq.ensure_capacity(self.pool, n)
        nb = len(seq.blocks)
        l, _, _, kv, d = cache_k.shape
        blocks = self._tensor(seq.blocks)
        self.pool.k[:, blocks] = cache_k[:, 0, :nb * bs].reshape(l, nb, bs, kv, d)
        self.pool.v[:, blocks] = cache_v[:, 0, :nb * bs].reshape(l, nb, bs, kv, d)
        seq.length = n

    def _table(self, ids: List[int]) -> np.ndarray:
        """The block tables of `ids` as a [B, max_blocks] array. Its width
        is a doubling bucket sized to the longest sequence (never truncate:
        a dropped block would silently corrupt attention while new tokens
        keep scattering into it)."""
        need = max(len(self.seqs[i].blocks) for i in ids)
        while self.max_blocks < need:
            self.max_blocks *= 2
        table = np.zeros((len(ids), self.max_blocks), np.int64)
        for row, i in enumerate(ids):
            table[row, : len(self.seqs[i].blocks)] = self.seqs[i].blocks
        return table

    @torch.no_grad()
    def step(self, only: Optional[Dict[int, Any]] = None) -> Dict[int, int]:
        """One decode step (eager) for all (or selected) active sequences;
        returns {seq_id: argmax token}."""
        ids = sorted(only if only is not None else self.seqs)
        if not ids:
            return {}
        bs = self.pool.block_size
        emb = self.params["embed"][self._tensor([self.last_token[i] for i in ids])][:, None]
        pos = self._tensor([[self.seqs[i].length] for i in ids])
        for i in ids:
            self.seqs[i].ensure_capacity(self.pool, 1)
        table = self._table(ids)
        wr_blocks = [self.seqs[i].blocks[self.seqs[i].length // bs] for i in ids]
        wr_offs = [self.seqs[i].length % bs for i in ids]
        lengths = self._tensor([self.seqs[i].length + 1 for i in ids])
        logits, k_new, v_new = paged_decode_step(self.params, self.cfg, emb, pos, self.pool,
                                                 self._tensor(table), lengths)
        # one batched scatter writes every sequence's new token (seqs own
        # disjoint blocks, so the (block, offset) pairs never collide)
        blocks, offs = self._tensor(wr_blocks), self._tensor(wr_offs)
        self.pool.k[:, blocks, offs] = k_new
        self.pool.v[:, blocks, offs] = v_new
        out = {}
        next_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        for row, i in enumerate(ids):
            self.seqs[i].length += 1
            out[i] = int(next_tokens[row])
            self.last_token[i] = out[i]
        return out

    def _get_chunk_fn(self, n: int, b: int, sampled: bool) -> _StepChunk:
        """The n-step decode chunk for a fixed active-batch size and table
        width: captured on first use on a CUDA device. With sampled=True the
        chunk reads per-row (temps, top_ps, greedy) and a uniform per row and
        step, so one batch mixes greedy and nucleus-sampled rows."""
        key = (n, b, self.max_blocks, sampled)
        cached = self._chunk_fns.lookup(key)
        if cached is None:
            cached = self._chunk_fns.store(key, _StepChunk(self, n, b, self.max_blocks, sampled))
        return cached

    @torch.no_grad()
    def step_n(self, n: int, sampling=None) -> Dict[int, List[int]]:
        """Decode n tokens for every active sequence in ONE program (a graph
        replay on a CUDA device; sequences join/leave between calls). Returns
        {seq_id: [tokens]}.

        sampling: None for greedy-all (argmax), or a dict
        {sid: (temperature, top_p, greedy)} plus key "uniforms" mapping to
        a [n, B] float32 tensor of uniforms in [0, 1), column r for the r-th
        sequence in sorted id order: rows sample independently by their
        own parameters and their own column."""
        ids = sorted(self.seqs)
        if not ids or n <= 0:
            return {}
        b = len(ids)
        for i in ids:
            self.seqs[i].ensure_capacity(self.pool, n)
        table = self._table(ids)
        sampled = sampling is not None
        fn = self._get_chunk_fn(n, b, sampled)
        fn.table.copy_(self._tensor(table))
        fn.lengths.copy_(self._tensor([self.seqs[i].length for i in ids]))
        fn.last.copy_(self._tensor([self.last_token[i] for i in ids]))
        if sampled:
            fn.temps.copy_(self._tensor([sampling[i][0] for i in ids], torch.float32))
            fn.top_ps.copy_(self._tensor([sampling[i][1] for i in ids], torch.float32))
            fn.greedy.copy_(self._tensor([sampling[i][2] for i in ids], torch.bool))
            fn.u.copy_(sampling["uniforms"])
        fn.run()
        toks_host = fn.toks.cpu().numpy()
        out = {}
        for row, i in enumerate(ids):
            self.seqs[i].length += n
            out[i] = [int(t) for t in toks_host[row]]
            self.last_token[i] = out[i][-1]
        return out

    def finish(self, sid: int) -> None:
        self.pool.release(self.seqs.pop(sid).blocks)
        self.last_token.pop(sid, None)
