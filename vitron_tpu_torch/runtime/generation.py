"""Autoregressive generation: multimodal prefill + KV-cached decode.

Port of `vitron_tpu/runtime/generation.py`: one prefill over the spliced
embeddings into a preallocated KV cache, then decode; sampling is greedy or
temperature + top-p; stopping is EOS ids plus the host-side
`KeywordStopper`, checked at the same points as the JAX package (every
`STOP_CHECK_EVERY` steps on the per-token path, at every emitted position on
the chunked path).

The chunked path (`decode_chunk` > 0, the default for int4 weights) decodes
a chunk of n tokens as one program, the counterpart of the JAX package's
`_get_chunk_fn` (`jax.jit` over `lax.scan`): n steps of
`vitron_model.decode_step` at a cache slot held on the device, over static
buffers (the KV cache, the last token, its position and slot, per-row
sampling parameters, a [n, B] buffer of uniforms, the [B, n] emitted
tokens). On a CUDA device the chunk is captured once as a CUDA graph
(`runtime/graphs.Chunk`) and every chunk replays it; on the CPU the same
steps run eagerly. The graphs, each with its own KV cache, live in a
`ProgramCache` keyed by (steps, batch, cache length, sampled). A request's
chunk always has `decode_chunk` steps and a cache length that is a power of
two of at least 512 slots (`cache_slots`), so requests of every pad bucket
and token budget that fit one length share one graph. Sampling
inside a chunk reads one uniform per row and step, which the host draws
from the request's `torch.Generator` before the chunk runs, so the eager
and the replayed chunk give the same tokens from one seed. A request's last
chunk runs all n steps, as the JAX scan does, and the host drops the tokens
past the budget. `generate_scan` is the fixed-length benchmark path: one
prefill and one chunk.

`batcher=` hands a single-row request to a `ContinuousBatcher`
(runtime/batching.py). Speculative decoding is not ported: it waits on the
reference fault C1 (ROADMAP), so `speculative=True` raises and
`speculative=None` never speculates.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.models.llm import llama
from vitron_tpu_torch.models.llm.paged_cache import sample_token_batched
from vitron_tpu_torch.runtime import graphs
from vitron_tpu_torch.runtime.telemetry import ProgramCache

STOP_CHECK_EVERY = 8  # per-token path: keyword-stop check interval, as in the JAX package
DECODE_GRAPHS = 8  # decode chunks (each with its KV cache) a Generator keeps
DEFAULT_DECODE_CHUNK = 128  # decode steps a chunk for packed-int4 weights, as in JAX
MIN_CACHE_SLOTS = 512  # a chat prompt's pad bucket (<= 384) + a chunk share one length


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.2
    top_p: float = 0.7
    max_new_tokens: int = 1024
    greedy: bool = False
    eos_ids: tuple = (2,)


def cache_slots(n: int) -> int:
    """The KV cache length of a decode chunk that needs n slots: the next
    power of two, at least MIN_CACHE_SLOTS."""
    return max(MIN_CACHE_SLOTS, 1 << max(n - 1, 0).bit_length())


def has_packed_int4(params) -> bool:
    """True if any leaf dict is a packed-int4 weight ({'q4', 's'})."""
    if isinstance(params, dict):
        return "q4" in params or any(has_packed_int4(v) for v in params.values())
    return False


def uniforms(shape, gen: Optional[torch.Generator], device) -> torch.Tensor:
    """float32 uniforms in [0, 1) drawn from `gen` (the global generator
    when None) and placed on `device`."""
    dev = gen.device if gen is not None else device
    return torch.rand(shape, generator=gen, device=dev).to(device)


def sample_token(logits: torch.Tensor, temperature: float, top_p: float, greedy: bool,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64). Nucleus (top-p) + temperature
    with the top-1 token always kept, by the inverse CDF of one uniform per
    row drawn from `gen` (`paged_cache.sample_token_batched`)."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    b = logits.shape[0]
    full = lambda v: torch.full((b,), v, dtype=torch.float32, device=logits.device)  # noqa: E731
    return sample_token_batched(logits, full(temperature), full(top_p),
                                torch.zeros(b, dtype=torch.bool, device=logits.device),
                                uniforms(b, gen, logits.device))


class _DecodeChunk:
    """n decode steps of a b-row batch over its own KV cache of t slots.
    Static buffers: `cache`, `token` [b, 1], `pos` [b, 1] and `index` [1]
    (the next step's input, position and cache slot, advanced in place by
    each step), `temps`/`top_ps` [b], `u` [n, b] (sampled chunks) and
    `emits` [b, n], the tokens the steps sampled."""

    def __init__(self, g: "Generator", n: int, b: int, t: int, sampled: bool):
        dev = g.device
        self.g, self.n, self.sampled = g, n, sampled
        self.cache = llama.KVCache.create(g.cfg.llm, b, max_len=t, device=dev)
        self.token = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.temps = torch.ones((b,), dtype=torch.float32, device=dev)
        self.top_ps = torch.ones((b,), dtype=torch.float32, device=dev)
        self.greedy = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.u = torch.zeros((n, b), dtype=torch.float32, device=dev)
        self.emits = torch.zeros((b, n), dtype=torch.int64, device=dev)
        self.run = graphs.Chunk(self._body, self._warmup, dev, g._stream, g._pool)

    def _step(self, i: int) -> None:
        logits, _ = vitron_model.decode_step(self.g.params, self.g.cfg, self.token, self.pos,
                                             self.cache, self.index)
        if self.sampled:
            nxt = sample_token_batched(logits[:, -1], self.temps, self.top_ps, self.greedy,
                                       self.u[i])
        else:
            nxt = torch.argmax(logits[:, -1], dim=-1)
        self.emits[:, i] = nxt
        self.token.copy_(nxt[:, None])
        self.pos.add_(1)
        self.index.add_(1)

    def _body(self) -> None:
        for i in range(self.n):
            self._step(i)

    def _warmup(self) -> None:
        """The first step, with the inputs it advances put back: the
        replay's first step then writes the same cache slot again."""
        inputs = (self.token, self.pos, self.index)
        saved = [t.clone() for t in inputs]
        self._step(0)
        for t, v in zip(inputs, saved):
            t.copy_(v)

    def start(self, token: torch.Tensor, pos: torch.Tensor, index: int,
              temperature: float, top_p: float) -> None:
        """Load the first decode input after a prefill into this cache."""
        self.token.copy_(token)
        self.pos.copy_(pos)
        self.index.fill_(index)
        self.temps.fill_(temperature)
        self.top_ps.fill_(top_p)

    def __call__(self, gen: Optional[torch.Generator]) -> np.ndarray:
        """Run the chunk; -> the [b, n] sampled tokens on the host (the
        chunk's one copy to the host)."""
        if self.sampled:
            self.u.copy_(uniforms(self.u.shape, gen, self.u.device))
        self.run()
        return self.emits.cpu().numpy()


class Generator:
    """Prefill + decode for one model; call `generate` per planned batch.
    On a CUDA device the decode chunks replay captured CUDA graphs."""

    def __init__(self, params: Dict[str, Any], cfg: vitron_model.VitronConfig, device=None):
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else \
            params["llm"]["embed"].device
        self.last_prefill_logits: Optional[torch.Tensor] = None  # [B, V] float32
        self.last_chunk: Optional[_DecodeChunk] = None  # the chunk the last request decoded with
        self.chunks = ProgramCache("generator-chunk", max_entries=DECODE_GRAPHS)
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        # one request at a time owns the chunks' static buffers
        self._lock = threading.Lock()

    def _t(self, a, dtype=None) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(self.device, dtype)
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    def _chunk(self, n: int, b: int, t: int, sampled: bool) -> _DecodeChunk:
        return self.chunks.get((n, b, t, sampled), lambda: _DecodeChunk(self, n, b, t, sampled))

    def _prefill(self, cache, token_ids, media_idx, use_media, positions, attn_mask, seq_lens,
                 images=None, videos=None, **kwargs) -> torch.Tensor:
        """Multimodal prefill into `cache` (reset first) -> the logits at
        each row's last real position [B, V]."""
        cache.valid.zero_()
        cache.index = 0
        logits, _ = vitron_model.forward(
            self.params, self.cfg,
            plan_token_ids=self._t(token_ids, torch.int64),
            plan_media_idx=self._t(media_idx, torch.int64),
            plan_use_media=self._t(use_media, torch.bool),
            positions=self._t(positions, torch.int64),
            attn_mask=self._t(attn_mask, torch.bool),
            images=None if images is None else images.to(self.device),
            videos=None if videos is None else videos.to(self.device),
            cache=cache, **kwargs)
        last = self._t(seq_lens, torch.int64) - 1
        next_logits = logits[torch.arange(logits.shape[0], device=self.device), last]
        self.last_prefill_logits = next_logits
        return next_logits

    @torch.no_grad()
    def generate(self, plan, images: Optional[torch.Tensor] = None,
                 videos: Optional[torch.Tensor] = None,
                 block_perm: Optional[np.ndarray] = None,
                 region_boxes: Optional[np.ndarray] = None,
                 sampling: SamplingConfig = SamplingConfig(),
                 gen: Optional[torch.Generator] = None, stopper=None,
                 decode_chunk: Optional[int] = None,
                 speculative: Optional[bool] = None, batcher=None) -> List[List[int]]:
        """Run prefill + decode for one planned batch; returns the new token
        ids per row. decode_chunk: None = 128 for packed-int4 weights,
        per-token stepping otherwise; 0 forces per-token stepping.
        `gen` drives sampling (a generator on the model's device).
        `batcher`: a single-row request is co-batched with other requests
        in flight on that `ContinuousBatcher` (which runs its prefill and
        decode on its own device loop)."""
        if speculative:
            raise NotImplementedError(
                "speculative decoding is not ported: it waits on fault C1 (ROADMAP)")
        b, pad_len = plan.token_ids.shape
        if batcher is not None and b == 1:
            fut = batcher.submit(plan, images=images, videos=videos, block_perm=block_perm,
                                 region_boxes=region_boxes, sampling=sampling,
                                 stopper=stopper, gen=gen)
            return [fut.result()]
        if decode_chunk is None and has_packed_int4(self.params):
            decode_chunk = DEFAULT_DECODE_CHUNK
        kwargs: Dict[str, Any] = {}
        if plan.region_blocks is not None and len(plan.region_blocks) and region_boxes is not None:
            kwargs["region_boxes"] = self._t(region_boxes, torch.float32)
            kwargs["region_block_idx"] = self._t(plan.region_blocks, torch.int64)
        if block_perm is not None:
            kwargs["block_perm"] = self._t(block_perm, torch.int64)
        arrays = (plan.token_ids, plan.media_idx, plan.use_media, plan.position_ids,
                  plan.attention_mask, plan.seq_lens)
        greedy = sampling.greedy or sampling.temperature == 0.0
        steps = sampling.max_new_tokens - 1
        with self._lock:
            chunk = None
            if decode_chunk and steps > 0:
                # the last chunk runs all its steps: room for them in the cache
                need = pad_len + -(-steps // decode_chunk) * decode_chunk
                chunk = self._chunk(decode_chunk, b, cache_slots(need), not greedy)
                cache = chunk.cache
            else:
                cache = llama.KVCache.create(self.cfg.llm, b,
                                             max_len=pad_len + sampling.max_new_tokens,
                                             device=self.device)
            next_logits = self._prefill(cache, *arrays, images=images, videos=videos, **kwargs)
            token = sample_token(next_logits, sampling.temperature, sampling.top_p,
                                 sampling.greedy, gen)[:, None]
            out_tokens: List[List[int]] = [[] for _ in range(b)]
            done = np.zeros(b, bool)
            pos = self._t(plan.seq_lens, torch.int64)[:, None]
            if decode_chunk:
                self.last_chunk = chunk
                return self._generate_chunked(token, pos, pad_len, chunk, out_tokens, done,
                                              gen, sampling, stopper)
            return self._generate_steps(token, pos, cache, out_tokens, done, gen, sampling,
                                        stopper)

    def _generate_steps(self, token, pos, cache, out_tokens, done, gen,
                        sampling: SamplingConfig, stopper):
        """Per-token stepping on the host fill level of the cache."""
        b = len(out_tokens)
        for step in range(sampling.max_new_tokens):
            tok_host = token[:, 0].cpu().numpy()
            for i in range(b):
                if not done[i]:
                    out_tokens[i].append(int(tok_host[i]))
                    if int(tok_host[i]) in sampling.eos_ids:
                        done[i] = True
            if done.all():
                break
            if stopper is not None and (step + 1) % STOP_CHECK_EVERY == 0:
                for i in range(b):
                    if not done[i] and stopper.should_stop(out_tokens[i]):
                        done[i] = True
                if done.all():
                    break
            if step == sampling.max_new_tokens - 1:
                break
            logits, _ = vitron_model.decode_step(self.params, self.cfg, token, pos, cache)
            token = sample_token(logits[:, -1], sampling.temperature, sampling.top_p,
                                 sampling.greedy, gen)[:, None]
            pos = pos + 1
        return out_tokens

    def _generate_chunked(self, token, pos, pad_len: int, chunk: Optional[_DecodeChunk],
                          out_tokens, done, gen, sampling: SamplingConfig, stopper):
        """Decode in chunks of `chunk.n` tokens (one graph replay each on a
        CUDA device; the tokens reach the host in one copy a chunk), then
        apply EOS and the stopper at every emitted position on the host."""
        b = len(out_tokens)
        tok_host = token[:, 0].cpu().numpy()
        for i in range(b):  # the prefill-sampled first token
            out_tokens[i].append(int(tok_host[i]))
            if int(tok_host[i]) in sampling.eos_ids:
                done[i] = True
            elif stopper is not None and stopper.should_stop(out_tokens[i]):
                done[i] = True
        produced = 1
        if chunk is not None:
            chunk.start(token, pos, pad_len, sampling.temperature, sampling.top_p)
        while produced < sampling.max_new_tokens and not done.all():
            buf_host = chunk(gen)
            n = min(chunk.n, sampling.max_new_tokens - produced)
            for i in range(b):
                for j in range(n):
                    if done[i]:
                        break
                    t = int(buf_host[i, j])
                    out_tokens[i].append(t)
                    if t in sampling.eos_ids:
                        done[i] = True
                    elif stopper is not None and stopper.should_stop(out_tokens[i]):
                        done[i] = True
            produced += n
        return out_tokens

    @torch.no_grad()
    def scan(self, plan_arrays, n_new: int, gen: Optional[torch.Generator] = None,
             images=None, videos=None, temperature: float = 0.0, top_p: float = 1.0,
             max_cache_len: Optional[int] = None) -> torch.Tensor:
        """`generate_scan` on this generator's chunks -> [B, n_new] token ids
        on the device."""
        token_ids = plan_arrays[0]
        b, pad_len = token_ids.shape
        t = max_cache_len or cache_slots(pad_len + n_new)
        if t < pad_len + n_new - 1:
            raise ValueError(f"max_cache_len {t} < {pad_len} prompt slots + {n_new - 1} steps")
        with self._lock:
            chunk = self._chunk(n_new - 1, b, t, temperature != 0.0) if n_new > 1 else None
            cache = chunk.cache if chunk is not None else llama.KVCache.create(
                self.cfg.llm, b, max_len=t, device=self.device)
            next_logits = self._prefill(cache, *plan_arrays, images=images, videos=videos)
            token = sample_token(next_logits, temperature, top_p, temperature == 0.0, gen)
            if chunk is None:
                return token[:, None]
            self.last_chunk = chunk
            chunk.start(token[:, None], self._t(plan_arrays[5], torch.int64)[:, None],
                        pad_len, temperature, top_p)
            chunk(gen)
            return torch.cat([token[:, None], chunk.emits], dim=1)


def generate_scan(params, cfg: vitron_model.VitronConfig, plan_arrays, n_new: int,
                  gen: Optional[torch.Generator] = None, images=None, videos=None,
                  temperature: float = 0.0, top_p: float = 1.0,
                  max_cache_len: Optional[int] = None,
                  generator: Optional[Generator] = None) -> torch.Tensor:
    """Fixed-length generation (the benchmark path): one prefill, then the
    n_new - 1 decode steps as one chunk (one CUDA graph replay on the card).
    The JAX scan runs n_new steps and drops the last step's token; this
    runs n_new - 1 and gives the same tokens.

    plan_arrays: (token_ids, media_idx, use_media, positions, attn_mask,
    seq_lens), arrays or tensors. Returns [B, n_new] token ids. `generator`
    (a `Generator` on the same params) keeps the captured chunk between
    calls; without one, each call builds and captures its own."""
    generator = generator or Generator(params, cfg)
    return generator.scan(plan_arrays, n_new, gen, images=images, videos=videos,
                          temperature=temperature, top_p=top_p, max_cache_len=max_cache_len)
