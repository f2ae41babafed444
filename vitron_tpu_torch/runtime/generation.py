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
(runtime/batching.py).

With VITRON_W4A8=1 (read once, when the Generator is built) the decode
chunks, the speculative graphs and `scan` run on `decode_params`, the
W4A8 promotion of the packed int4 weights (Q1), where the JAX package
calls `promote_int4` inside those programs; `generate`'s prefill and the
per-token path keep B1's int4 leaves, as JAX's unpromoted programs do.

Speculative decoding (runtime/speculative.py) follows the JAX package's
policy: `speculative=None` speculates on every greedy single-row request
unless `VITRON_SPEC` is "0"; with "1" (the default) it probes first -- the
first decode chunk runs plain, then `hypothetical_tpf` replays the
prompt-lookup acceptance on what it emitted, and the request upgrades to
speculative segments only when that reaches `VITRON_SPEC_TPF_MIN` (1.5)
tokens a forward; with "2", or `speculative=True`, it speculates at once.
Without a stopper the whole budget is one segment; with one, segments of
at most 64 tokens, checked on the host between them, and the request falls
back to plain chunks on the same cache when the tokens per forward drop
below `VITRON_SPEC_TPF_MIN` after 8 forwards. A speculative request's cache
(a power of two, like a plain chunk's; `spec_cache_need`) is shared by its
plain chunk and its `_SpecChunk`, a CUDA graph of `SPEC_FORWARDS` verify
forwards (masked once the segment's budget is met or the stream is done)
that the host replays until the segment ends. `last_spec_stats` counts the
forwards that emit, as the JAX package does.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vitron_tpu_torch.kernels.quantization import promote_int4
from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.models.llm import llama
from vitron_tpu_torch.models.llm.paged_cache import sample_token_batched
from vitron_tpu_torch.runtime import graphs
from vitron_tpu_torch.runtime import speculative as spec_mod
from vitron_tpu_torch.runtime.telemetry import ProgramCache

STOP_CHECK_EVERY = 8  # per-token path: keyword-stop check interval, as in the JAX package
DECODE_GRAPHS = 8  # decode chunks (each with its KV cache) a Generator keeps
DEFAULT_DECODE_CHUNK = 128  # decode steps a chunk for packed-int4 weights, as in JAX
MIN_CACHE_SLOTS = 512  # a chat prompt's pad bucket (<= 384) + a chunk share one length
SPEC_SEGMENT = 64  # tokens a speculative segment may emit before the host checks the stopper
SPEC_FORWARDS = 4  # verify forwards a speculative graph replay runs (tools/spec_forwards.py)
SPEC_MIN_FORWARDS = 8  # forwards before the acceptance may send a request back to plain chunks


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.2
    top_p: float = 0.7
    max_new_tokens: int = 1024
    greedy: bool = False
    eos_ids: tuple = (2,)


def spec_settings():
    """(VITRON_SPEC, VITRON_SPEC_TPF_MIN), read per request under the JAX
    package's names and defaults: the mode "0" off / "1" probe / "2" at
    once, and the tokens per forward below which speculation does not pay."""
    return (os.environ.get("VITRON_SPEC", "1"),
            float(os.environ.get("VITRON_SPEC_TPF_MIN", "1.5")))


def cache_slots(n: int) -> int:
    """The KV cache length of a decode chunk that needs n slots: the next
    power of two, at least MIN_CACHE_SLOTS."""
    return max(MIN_CACHE_SLOTS, 1 << max(n - 1, 0).bit_length())


def spec_cache_need(pad_len: int, max_new: int, n: int, k: int, probe: bool,
                    segmented: bool) -> int:
    """KV slots a speculative request on decode chunks of n steps needs:
    the plain path's (whole chunks from the prompt) where the probe's first
    chunk covers the budget, so that no verify forward can run; else room
    for the verify window (k + 1 slots from the last token's, the JAX
    package's pad_len + max_new + k + 1) and, where segments may fall back,
    for whole plain chunks from any frontier (at most n - 2 slots past the
    budget's last)."""
    plain = pad_len + -(-(max_new - 1) // n) * n
    if probe and max_new - 1 <= n:
        return plain
    need = max(plain, pad_len + max_new + k + 1)
    return max(need, pad_len + max_new + n - 2) if segmented else need


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
        self.cache = llama.KVCache.create(g.cfg.llm, b, max_len=t, device=dev,
                                          kv_heads=g.kv_heads())
        self.token = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.temps = torch.ones((b,), dtype=torch.float32, device=dev)
        self.top_ps = torch.ones((b,), dtype=torch.float32, device=dev)
        self.greedy = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.u = torch.zeros((n, b), dtype=torch.float32, device=dev)
        self.emits = torch.zeros((b, n), dtype=torch.int64, device=dev)
        self.run = graphs.Chunk(self._body, self._warmup, dev, g._stream, g._pool)
        self.spec: Dict[Any, "_SpecChunk"] = {}  # speculative graphs on this chunk's cache

    def _step(self, i: int) -> None:
        logits, _ = vitron_model.decode_step(self.g.decode_params, self.g.cfg, self.token,
                                             self.pos, self.cache, self.index)
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

    def resume(self, st: spec_mod.SpecState) -> None:
        """Continue a speculative stream's frontier (one row, greedy): its
        last token, position and cache slot, copied on the device."""
        self.token.copy_(st.last_tok.view(1, 1))
        self.pos.copy_(st.pos.view(1, 1))
        self.index.copy_(st.slot)

    def __call__(self, gen: Optional[torch.Generator]) -> np.ndarray:
        """Run the chunk; -> the [b, n] sampled tokens on the host (the
        chunk's one copy to the host)."""
        if self.sampled:
            self.u.copy_(uniforms(self.u.shape, gen, self.u.device))
        self.run()
        return self.emits.cpu().numpy()


class _SpecChunk:
    """`forwards` speculative verify forwards of one greedy stream over a
    plain chunk's KV cache (the JAX segment's `while_loop` body with a
    fixed trip count): a CUDA graph on the card, eager on the CPU. Static
    buffers: the stream's `SpecState` (history as long as the cache) and
    the EOS ids. A forward that starts with the segment's budget met or the
    stream done is masked (`speculative.verify_forward`)."""

    def __init__(self, g: "Generator", plain: _DecodeChunk, k: int, ngram: int,
                 eos_ids: tuple, forwards: int):
        dev = g.device
        self.g, self.k, self.ngram, self.forwards = g, k, ngram, forwards
        self.cache = plain.cache
        self.state = spec_mod.SpecState.create(self.cache.k.shape[2], k, dev)
        self.eos = spec_mod.eos_tensor(eos_ids, dev)
        self.run = graphs.Chunk(self._body, self._warmup, dev, g._stream, g._pool)

    def _forward(self) -> None:
        spec_mod.verify_forward(self.g.decode_params, self.g.cfg, self.state, self.cache,
                                self.k, self.ngram, self.eos)

    def _body(self) -> None:
        for _ in range(self.forwards):
            self._forward()

    def _warmup(self) -> None:
        """One forward, with every state buffer it advances put back (the
        cache window it writes is written again by the replay's first
        forward)."""
        saved = [t.clone() for t in self.state.tensors()]
        self._forward()
        for t, v in zip(self.state.tensors(), saved):
            t.copy_(v)

    def segment(self, seg: int, limit: int):
        """One segment of at most min(seg, limit) tokens: replays until its
        budget is met or the stream is done. -> (tokens, emitted, forwards
        that emitted, done, replays); the host reads the counts after each
        replay and the tokens once."""
        st = self.state
        budget = min(seg, limit)
        st.begin_segment(budget)
        replays, out_n, steps, done = 0, 0, 0, False
        while budget > 0:
            self.run()
            replays += 1
            out_n, steps, done = torch.cat([st.out_n, st.seg_steps,
                                            st.done.to(torch.int64)]).tolist()
            if out_n >= budget or done:
                break
        return st.out_buf[:out_n].tolist(), out_n, steps, bool(done), replays


class Generator:
    """Prefill + decode for one model; call `generate` per planned batch.
    On a CUDA device the decode chunks replay captured CUDA graphs."""

    def __init__(self, params: Dict[str, Any], cfg: vitron_model.VitronConfig, device=None):
        self.params = params
        # the tree of the decode chunks, the speculative graphs and `scan`:
        # W4A8 leaves when VITRON_W4A8=1 (read here, once), where the JAX
        # package promotes inside those programs
        self.decode_params = promote_int4(params)
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else \
            params["llm"]["embed"].device
        self.last_prefill_logits: Optional[torch.Tensor] = None  # [B, V] float32
        self.last_chunk: Optional[_DecodeChunk] = None  # the chunk the last request decoded with
        self.chunks = ProgramCache("generator-chunk", max_entries=DECODE_GRAPHS)
        self.last_spec_stats: Optional[Dict[str, Any]] = None
        # the last request's segments: (emitted, forwards that emitted, replays) each
        self.last_spec_segments: List[tuple] = []
        # segments that emitted nothing (the JAX package's defensive
        # fallback to plain chunks); 0 expected
        self.zero_emission_segments = 0
        self._stream = self._pool = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        # one request at a time owns the chunks' static buffers
        self._lock = threading.Lock()

    def set_params(self, params: Dict[str, Any]) -> None:
        """Replace the params (`sharded_serving.install_mesh` places them on
        a mesh): the decode tree is promoted anew and the chunks, whose
        caches and graphs were made for the old params, are dropped."""
        with self._lock:
            self.params = params
            self.decode_params = promote_int4(params)
            self.chunks = ProgramCache("generator-chunk", max_entries=DECODE_GRAPHS)
            self.last_chunk = None

    def kv_heads(self) -> int:
        """The KV heads of this rank's caches: all of them on one device,
        this rank's block on a mesh whose attention splits over `tensor`
        (the caches' placement follows the params `install_mesh` placed)."""
        return llama.local_kv_heads(self.params["llm"], self.cfg.llm)

    def _t(self, a, dtype=None) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(self.device, dtype)
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    def _chunk(self, n: int, b: int, t: int, sampled: bool) -> _DecodeChunk:
        return self.chunks.get((n, b, t, sampled), lambda: _DecodeChunk(self, n, b, t, sampled))

    def _prefill(self, cache, token_ids, media_idx, use_media, positions, attn_mask, seq_lens,
                 images=None, videos=None, params=None, **kwargs) -> torch.Tensor:
        """Multimodal prefill into `cache` (reset first) -> the logits at
        each row's last real position [B, V]; `params` defaults to the
        generator's own."""
        cache.valid.zero_()
        cache.index = 0
        logits, _ = vitron_model.forward(
            self.params if params is None else params, self.cfg,
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

    def _spec_chunk(self, plain: _DecodeChunk, k: int, ngram: int, eos_ids) -> _SpecChunk:
        """The speculative graph on `plain`'s cache (the counterpart of the
        JAX package's `_get_spec_fn` / `_get_spec_seg_fns` programs), kept
        with the plain chunk, so the two always share one cache."""
        key = (k, ngram, tuple(eos_ids), SPEC_FORWARDS)
        if key not in plain.spec:
            plain.spec[key] = _SpecChunk(self, plain, k, ngram, tuple(eos_ids), SPEC_FORWARDS)
        return plain.spec[key]

    def _spec_segment(self, spec: _SpecChunk, seg: int, limit: int):
        """One speculative segment -> (tokens, emitted, forwards, done)."""
        toks, n, steps, done, replays = spec.segment(seg, limit)
        self.last_spec_segments.append((n, steps, replays))
        return toks, n, steps, done

    @torch.no_grad()
    def generate(self, plan, images: Optional[torch.Tensor] = None,
                 videos: Optional[torch.Tensor] = None,
                 block_perm: Optional[np.ndarray] = None,
                 region_boxes: Optional[np.ndarray] = None,
                 sampling: SamplingConfig = SamplingConfig(),
                 gen: Optional[torch.Generator] = None, stopper=None,
                 decode_chunk: Optional[int] = None,
                 speculative: Optional[bool] = None, spec_k: int = 4, spec_ngram: int = 2,
                 batcher=None) -> List[List[int]]:
        """Run prefill + decode for one planned batch; returns the new token
        ids per row. decode_chunk: None = 128 for packed-int4 weights,
        per-token stepping otherwise; 0 forces per-token stepping.
        `gen` drives sampling (a generator on the model's device).
        `speculative`: prompt-lookup speculation for greedy single-row
        requests (the module docstring's policy; None = auto, True = at
        once, False = off), drafts of `spec_k` tokens from `spec_ngram`-token
        keys; `last_spec_stats` describes the last request (None when it did
        not speculate). `batcher`: a single-row request is co-batched with
        other requests in flight on that `ContinuousBatcher` (which runs its
        prefill and decode on its own device loop)."""
        self.last_spec_stats = None
        self.last_spec_segments = []
        b, pad_len = plan.token_ids.shape
        if batcher is not None and b == 1:
            fut = batcher.submit(plan, images=images, videos=videos, block_perm=block_perm,
                                 region_boxes=region_boxes, sampling=sampling,
                                 stopper=stopper, gen=gen)
            return [fut.result()]
        if decode_chunk is None and has_packed_int4(self.params):
            decode_chunk = DEFAULT_DECODE_CHUNK
        greedy = sampling.greedy or sampling.temperature == 0.0
        explicit = speculative is True
        spec_env, _ = spec_settings()
        if speculative is None:
            speculative = greedy and b == 1 and spec_env != "0"
        speculative = bool(speculative) and greedy and b == 1
        probe = speculative and not explicit and spec_env != "2"
        kwargs: Dict[str, Any] = {}
        if plan.region_blocks is not None and len(plan.region_blocks) and region_boxes is not None:
            kwargs["region_boxes"] = self._t(region_boxes, torch.float32)
            kwargs["region_block_idx"] = self._t(plan.region_blocks, torch.int64)
        if block_perm is not None:
            kwargs["block_perm"] = self._t(block_perm, torch.int64)
        arrays = (plan.token_ids, plan.media_idx, plan.use_media, plan.position_ids,
                  plan.attention_mask, plan.seq_lens)
        steps = sampling.max_new_tokens - 1
        with self._lock:
            chunk = None
            if speculative:
                n = decode_chunk or DEFAULT_DECODE_CHUNK
                need = spec_cache_need(pad_len, sampling.max_new_tokens, n, spec_k, probe,
                                       segmented=probe or stopper is not None)
                chunk = self._chunk(n, b, cache_slots(need), False)
                cache = chunk.cache
            elif decode_chunk and steps > 0:
                # the last chunk runs all its steps: room for them in the cache
                need = pad_len + -(-steps // decode_chunk) * decode_chunk
                chunk = self._chunk(decode_chunk, b, cache_slots(need), not greedy)
                cache = chunk.cache
            else:
                cache = llama.KVCache.create(self.cfg.llm, b,
                                             max_len=pad_len + sampling.max_new_tokens,
                                             device=self.device, kv_heads=self.kv_heads())
            next_logits = self._prefill(cache, *arrays, images=images, videos=videos, **kwargs)
            token = sample_token(next_logits, sampling.temperature, sampling.top_p,
                                 sampling.greedy, gen)[:, None]
            out_tokens: List[List[int]] = [[] for _ in range(b)]
            done = np.zeros(b, bool)
            pos = self._t(plan.seq_lens, torch.int64)[:, None]
            if chunk is not None:
                self.last_chunk = chunk
            if speculative:
                seq_len = int(plan.seq_lens[0])
                if probe:
                    return [self._probe_generate(plan, chunk, token, pos, pad_len, gen,
                                                 sampling, stopper, spec_k, spec_ngram)]
                tok0 = int(token[0, 0])
                spec = self._spec_chunk(chunk, spec_k, spec_ngram, sampling.eos_ids)
                spec_mod.spec_init_state(tok0, pad_len, plan.token_ids[0], seq_len,
                                         sampling.max_new_tokens, spec_k, sampling.eos_ids,
                                         out=spec.state)
                if stopper is None:
                    return [self._spec_whole(spec, tok0, sampling)]
                return [self._run_spec_segments(chunk, spec, [tok0], gen, sampling, stopper)]
            if decode_chunk:
                return self._generate_chunked(token, pos, pad_len, chunk, out_tokens, done,
                                              gen, sampling, stopper)
            return self._generate_steps(token, pos, cache, out_tokens, done, gen, sampling,
                                        stopper)

    def _spec_whole(self, spec: _SpecChunk, tok0: int, sampling: SamplingConfig) -> List[int]:
        """No stopper: the whole budget as one segment (JAX's `_get_spec_fn`
        program), the tokens cut after the first EOS."""
        n_new = sampling.max_new_tokens
        toks, n, steps, _ = self._spec_segment(spec, n_new, n_new - 1)
        self.last_spec_stats = {"emitted": n + 1, "forwards": steps + 1}  # + the prefill
        row: List[int] = []
        for t in [tok0] + toks:
            row.append(int(t))
            if int(t) in sampling.eos_ids:
                break
        return row

    def _run_spec_segments(self, plain: _DecodeChunk, spec: _SpecChunk, row: List[int], gen,
                           sampling: SamplingConfig, stopper,
                           extra_stats: Optional[Dict[str, Any]] = None) -> List[int]:
        """Segmented speculation from the state loaded in `spec` (after the
        prefill or at a probe's frontier), the stopper checked between
        segments; back to plain chunks on the same cache when the tokens per
        forward fall below VITRON_SPEC_TPF_MIN after SPEC_MIN_FORWARDS
        forwards, or when a segment emits nothing (the JAX package's
        defensive branch, counted in `zero_emission_segments`; its other
        branch, a segment after one that set done without emitting the EOS,
        is ROADMAP C1's and cannot occur here)."""
        _, tpf_min = spec_settings()
        seg = min(SPEC_SEGMENT, sampling.max_new_tokens)
        base, forwards, fell_back = len(row), 0, False
        stop = row[-1] in sampling.eos_ids or (stopper is not None and stopper.should_stop(row))
        while not stop and len(row) < sampling.max_new_tokens:
            toks, n, steps, _ = self._spec_segment(
                spec, seg, sampling.max_new_tokens - len(row))
            forwards += steps
            if n == 0:
                # done is set only with its EOS emitted, which stopped the row
                self.zero_emission_segments += 1
                fell_back = True
                break
            for t in toks:
                row.append(int(t))
                if int(t) in sampling.eos_ids or (stopper is not None
                                                  and stopper.should_stop(row)):
                    stop = True
                    break
            if (not stop and forwards >= SPEC_MIN_FORWARDS
                    and (len(row) - base) / forwards < tpf_min):
                fell_back = True
                break
        if fell_back and len(row) < sampling.max_new_tokens:
            plain.resume(spec.state)
            row = self._generate_chunked(None, None, 0, plain, [row], np.zeros(1, bool), gen,
                                         sampling, stopper, record_first=False)[0]
        self.last_spec_stats = {"emitted": len(row), "forwards": forwards + 1,  # + the prefill
                                "fell_back": fell_back, **(extra_stats or {})}
        return row

    def _probe_generate(self, plan, plain: _DecodeChunk, token, pos, pad_len: int, gen,
                        sampling: SamplingConfig, stopper, spec_k: int,
                        spec_ngram: int) -> List[int]:
        """The speculative default: the first chunk decodes plain, then
        `hypothetical_tpf` replays the prompt-lookup acceptance on what it
        emitted (no device work); below VITRON_SPEC_TPF_MIN the request stays
        plain, else it goes on as speculative segments from that frontier."""
        eos = sampling.eos_ids
        row = [int(token[0, 0])]
        stats: Dict[str, Any] = {"mode": "probe_plain", "probe_tpf": 0.0}
        if row[0] in eos or (stopper is not None and stopper.should_stop(row)) \
                or sampling.max_new_tokens <= 1:
            self.last_spec_stats = {"emitted": 1, "forwards": 1, "fell_back": False, **stats}
            return row
        plain.start(token, pos, pad_len, sampling.temperature, sampling.top_p)
        stop = False
        for t in plain(gen)[0, :sampling.max_new_tokens - 1]:
            row.append(int(t))
            if int(t) in eos or (stopper is not None and stopper.should_stop(row)):
                stop = True
                break
        seq_len = int(plan.seq_lens[0])
        tpf = spec_mod.hypothetical_tpf(plan.token_ids[0], seq_len, row, k=spec_k,
                                        ngram=spec_ngram)
        stats["probe_tpf"] = round(tpf, 3)
        if stop or len(row) >= sampling.max_new_tokens:
            self.last_spec_stats = {"emitted": len(row), "forwards": len(row),
                                    "fell_back": False, **stats}
            return row
        _, tpf_min = spec_settings()
        if tpf < tpf_min:  # stay plain: no speculative forward is run
            row = self._generate_chunked(None, None, 0, plain, [row], np.zeros(1, bool), gen,
                                         sampling, stopper, record_first=False)[0]
            self.last_spec_stats = {"emitted": len(row), "forwards": len(row),
                                    "fell_back": False, **stats}
            return row
        stats["mode"] = "probe_spec"
        spec = self._spec_chunk(plain, spec_k, spec_ngram, eos)
        spec_mod.spec_resume_state(row[-1], plain.index, plan.token_ids[0], seq_len, row,
                                   sampling.max_new_tokens, spec_k, out=spec.state)
        return self._run_spec_segments(plain, spec, row, gen, sampling, stopper,
                                       extra_stats=stats)

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
                          out_tokens, done, gen, sampling: SamplingConfig, stopper,
                          record_first: bool = True):
        """Decode in chunks of `chunk.n` tokens (one graph replay each on a
        CUDA device; the tokens reach the host in one copy a chunk), then
        apply EOS and the stopper at every emitted position on the host.
        record_first=False resumes rows already under way: the chunk's
        buffers hold their frontier (the last emitted token, not yet in the
        cache) and the budget counts the tokens in `out_tokens`."""
        b = len(out_tokens)
        if record_first:
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
        else:
            produced = max(len(row) for row in out_tokens)
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
                self.cfg.llm, b, max_len=t, device=self.device, kv_heads=self.kv_heads())
            next_logits = self._prefill(cache, *plan_arrays, images=images, videos=videos,
                                        params=self.decode_params)
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
