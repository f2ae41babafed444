"""Prompt-lookup speculative decoding (greedy, single stream).

Port of `vitron_tpu/runtime/speculative.py`. A decode step streams every
weight to produce one token; a verify forward over a window of k + 1 tokens
(the last emitted token and k drafted ones) reads the same weights once, so
each accepted draft is a nearly free extra token. Drafts come from prompt
lookup: the k tokens that followed the most recent earlier occurrence of
the last `ngram` tokens in the prompt + emitted history (`ngram_draft`).
Every emitted token is the argmax of the window's forward, so the output is
the greedy continuation; it is not bitwise the one-token loop's, since the
window's sums run in another order, and a near-tied argmax can break the
other way (the caveat of the JAX package, which holds here too).

The state of a stream (`SpecState`) is a set of device tensors: the last
emitted token, the cache slot and position it goes to next, the history
buffer and its fill level, the done flag and the forward count, and the
current segment's output buffer, emission count and budget. The history
buffer is at least `pad_len + n_new + k + 1` long (`spec_init_state`'s
layout); the whole argmax window g is written at `hist_len`, but `hist_len`
advances only by the emitted count, so rejected tokens stay past the
frontier, where a later draft's continuation may read them (JAX :214-215).
Every read and write at a device offset clamps its start as JAX's
`dynamic_slice` / `dynamic_update_slice` do; with the buffer sizes here the
clamp never moves a start.

`verify_forward` is one iteration of the JAX segment's `while_loop` body,
written so that it also runs when the loop's condition is false: such a
forward is masked (nothing it computes is kept: no emission, no history or
output write, the slot stays). The forward's K/V writes at the slot are
harmless by the cache-rollback invariant: every forward writes exactly
k + 1 slots at `slot` and advances `slot` by the emitted count, so stale
slots are overwritten by the next forward's window before any query can
see them (the mask is slot-causal). A CUDA graph of F such forwards
(`runtime/generation._SpecChunk`) therefore replays a segment's
data-dependent loop with a fixed trip count: the host replays it until the
budget is met or the stream is done. `speculative_segment` runs the loop
eagerly with the JAX package's condition checked on the host before each
forward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from vitron_tpu_torch.kernels.quantization import promote_int4
from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.models.llm import llama


def _arange(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def _window(buf: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of buf[start:start + size], the start clamped to [0, len -
    size] as JAX's dynamic_slice clamps it."""
    return torch.clamp(start, 0, buf.shape[0] - size) + _arange(size, buf.device)


def _write(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor,
           keep: torch.Tensor) -> None:
    """buf[start:start + len(vals)] = vals where `keep` (a [1] bool), in place."""
    idx = _window(buf, start, vals.shape[0])
    buf.index_copy_(0, idx, torch.where(keep, vals, buf[idx]))


def ngram_draft(history: torch.Tensor, hist_len: torch.Tensor, last_token: torch.Tensor,
                k: int, ngram: int = 2) -> torch.Tensor:
    """Propose k continuation tokens by n-gram lookup over the history.

    history: [T] int64 (garbage past hist_len); hist_len and last_token:
    one-element int64 tensors (the token the continuation must follow is
    history's last real entry). -> [k] int64: the k tokens after the most
    recent earlier occurrence of the last `ngram` real tokens whose
    continuation starts inside the real history (which excludes the key's
    own occurrence at the tail), else last_token repeated."""
    t = history.shape[0]
    key = history[_window(history, hist_len.reshape(()) - ngram, ngram)]
    windows = history.unfold(0, ngram, 1)                    # [t - ngram + 1, ngram]
    starts = _arange(t - ngram + 1, history.device)
    usable = (windows == key).all(dim=1) & (starts + ngram < hist_len.reshape(()))
    best = torch.where(usable, starts, -1).max()
    cont = history[_window(history, best.clamp(min=0) + ngram, k)]
    return torch.where(best >= 0, cont, last_token.reshape(()).expand(k))


def _first_eos_truncate(g: torch.Tensor, acc: torch.Tensor, eos: torch.Tensor):
    """g: [k+1] greedy tokens, acc: the accepted drafts (0-d). -> (n_emit,
    any_eos), 0-d: emissions cut at the first EOS among the acc + 1
    emittable tokens."""
    emittable = _arange(g.shape[0], g.device) <= acc
    is_eos = (g[:, None] == eos[None, :]).any(dim=-1) & emittable
    any_eos = is_eos.any()
    first = is_eos.to(torch.int64).argmax()   # the first True (0 if none)
    return torch.where(any_eos, first + 1, acc + 1), any_eos


def eos_tensor(eos_ids: Sequence[int], device) -> torch.Tensor:
    return torch.as_tensor(list(eos_ids) or [-1], dtype=torch.int64, device=device)


@dataclasses.dataclass
class SpecState:
    """A speculative stream's state, each entry a device tensor (one-element
    int64 unless noted): `last_tok` (emitted, not yet in the cache), `slot`
    (its cache slot), `pos` (its position), `history` [H], `hist_len`,
    `done` (bool), `steps` (forwards run, all segments); and the current
    segment's `out_buf` [H + k + 1], `out_n`, `seg_steps` and `budget`."""

    last_tok: torch.Tensor
    slot: torch.Tensor
    pos: torch.Tensor
    history: torch.Tensor
    hist_len: torch.Tensor
    done: torch.Tensor
    steps: torch.Tensor
    out_buf: torch.Tensor
    out_n: torch.Tensor
    seg_steps: torch.Tensor
    budget: torch.Tensor

    @staticmethod
    def create(size: int, k: int, device) -> "SpecState":
        def one():
            return torch.zeros((1,), dtype=torch.int64, device=device)

        return SpecState(last_tok=one(), slot=one(), pos=one(),
                         history=torch.zeros((size,), dtype=torch.int64, device=device),
                         hist_len=one(), done=torch.zeros((1,), dtype=torch.bool, device=device),
                         steps=one(),
                         out_buf=torch.full((size + k + 1,), -1, dtype=torch.int64,
                                            device=device),
                         out_n=one(), seg_steps=one(), budget=one())

    def tensors(self) -> Tuple[torch.Tensor, ...]:
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))

    def begin_segment(self, budget: int) -> None:
        self.out_n.zero_()
        self.seg_steps.zero_()
        self.budget.fill_(budget)

    def active(self) -> torch.Tensor:
        """[1] bool: the JAX segment loop's condition (out_n < budget, not done)."""
        return (self.out_n < self.budget) & ~self.done


def _load(out: Optional[SpecState], size: int, k: int, device, last_tok: int, slot,
          pos: int, history: np.ndarray, hist_len: int, done: bool) -> SpecState:
    """Fill `out` (or a new state of `size` history slots) from host values;
    `slot` may be a one-element device tensor (copied on the device)."""
    st = out if out is not None else SpecState.create(size, k, device)
    if st.history.shape[0] < history.shape[0]:
        raise ValueError(f"history of {history.shape[0]} slots > the state's "
                         f"{st.history.shape[0]}")
    st.history.zero_()
    st.history[:history.shape[0]].copy_(torch.from_numpy(history.astype(np.int64)))
    st.last_tok.fill_(int(last_tok))
    if torch.is_tensor(slot):
        st.slot.copy_(slot.reshape(1))
    else:
        st.slot.fill_(int(slot))
    st.pos.fill_(int(pos))
    st.hist_len.fill_(int(hist_len))
    st.done.fill_(bool(done))
    st.steps.zero_()
    st.out_buf.fill_(-1)
    st.begin_segment(0)
    return st


def spec_init_state(tok0: int, index, prompt_ids, seq_len: int, n_new: int, k: int,
                    eos_ids: Tuple[int, ...] = (2,), device=None,
                    out: Optional[SpecState] = None) -> SpecState:
    """The decode-loop state after the prefill: history = zeros, the padded
    prompt row at 0, tok0 at seq_len; the history is pad_len + n_new + k + 1
    long (`out`, when given, is filled in place and may be longer).
    `index` is the cache slot after the prefill (an int or a device tensor)."""
    prompt = np.asarray(prompt_ids, np.int64)
    pad_len = prompt.shape[0]
    history = np.zeros((pad_len + n_new + k + 1,), np.int64)
    history[:pad_len] = prompt
    history[int(seq_len)] = int(tok0)
    return _load(out, history.shape[0], k, device, int(tok0), index, int(seq_len), history,
                 int(seq_len) + 1, int(tok0) in tuple(eos_ids))


def spec_resume_state(last_tok: int, index, prompt_row, seq_len: int, emitted,
                      n_new: int, k: int, device=None,
                      out: Optional[SpecState] = None) -> SpecState:
    """The state at a plain chunked decode's frontier (the probe's hand-over
    to speculation): `emitted` are the tokens so far (tok0 first; the last
    one not yet in the cache, the chunked loop's invariant and the segment
    body's: its inputs are [last_tok, draft...] written at `index`)."""
    prompt = np.asarray(prompt_row, np.int64)
    pad_len = prompt.shape[0]
    history = np.zeros((pad_len + n_new + k + 1,), np.int64)
    history[:pad_len] = prompt
    n_emit = len(emitted)
    history[seq_len:seq_len + n_emit] = np.asarray(emitted, np.int64)
    return _load(out, history.shape[0], k, device, int(last_tok), index,
                 seq_len + n_emit - 1, history, seq_len + n_emit, False)


def hypothetical_tpf(prompt_row, seq_len: int, emitted, k: int = 4, ngram: int = 2) -> float:
    """Host-side replay of the prompt-lookup acceptance on already emitted
    greedy tokens: the zero-device-cost probe of `Generator.generate`.

    Greedy speculation emits the greedy continuation, so the drafts it would
    have proposed depend only on (prompt, emitted so far). Returns emitted
    tokens per forward over `emitted[1:]` (tok0 comes from the prefill).
    Carried over from the JAX package as it is, drafts padded with -1 to k
    included. Where it drifts from the device: a device draft whose
    continuation runs past the history's frontier reads the buffer's stale
    tail (rejected tokens of earlier windows, or zeros), which a host replay
    of (prompt, emitted) cannot know; this replay cuts such a draft short
    (-1 matches nothing), so its count can differ from the device's."""
    seq = list(np.asarray(prompt_row[:seq_len]).tolist()) + [int(t) for t in emitted]
    base = seq_len + 1          # the first drafted position (after tok0)
    total = len(seq)
    if total - base <= 0:
        return 0.0
    forwards = 0
    i = base
    while i < total:
        hist = seq[:i]
        key = tuple(hist[-ngram:])
        draft = None
        # the most recent occurrence of `key` with its continuation inside hist
        for s in range(len(hist) - ngram - 1, -1, -1):
            if tuple(hist[s:s + ngram]) == key:
                draft = hist[s + ngram:s + ngram + k]
                break
        if draft is None:
            draft = [hist[-1]] * k
        draft = (draft + [-1] * k)[:k]
        acc = 0
        while acc < k and i + acc < total and draft[acc] == seq[i + acc]:
            acc += 1
        i += acc + 1
        forwards += 1
    return (total - base) / max(forwards, 1)


def verify_forward(params, cfg: vitron_model.VitronConfig, st: SpecState, cache: llama.KVCache,
                   k: int, ngram: int, eos: torch.Tensor) -> None:
    """One verify forward of the segment loop, in place on `st` and `cache`:
    draft, run the k + 1 window at `st.slot`, accept the longest prefix of
    drafts equal to the argmax, cut at the first EOS and at the segment's
    budget, write the window's argmax g at the output and history
    frontiers, advance by the emitted count, and set done if an EOS was
    emitted. Masked (nothing kept) when the loop's condition is false on
    entry. No host sync."""
    active = st.active()
    draft = ngram_draft(st.history, st.hist_len, st.last_tok, k, ngram)
    inputs = torch.cat([st.last_tok, draft])[None]                  # [1, k+1]
    positions = (st.pos + _arange(k + 1, st.pos.device))[None]      # [1, k+1]
    logits, _ = vitron_model.decode_step(params, cfg, inputs, positions, cache, st.slot)
    g = logits[0].argmax(dim=-1)                                     # [k+1]
    acc = torch.cumprod((draft == g[:k]).to(torch.int64), dim=0).sum()
    n_eos, any_eos = _first_eos_truncate(g, acc, eos)
    # cap at the segment's budget, so the frontiers track the kept tail only
    room = st.budget - st.out_n
    n_emit = torch.where(active, torch.minimum(n_eos, room), 0)
    _write(st.out_buf, st.out_n, g, active)
    _write(st.history, st.hist_len, g, active)
    st.last_tok.copy_(torch.where(active, g[(n_emit - 1).clamp(min=0)], st.last_tok))
    for t in (st.slot, st.pos, st.hist_len, st.out_n):
        t.add_(n_emit)
    # done only if the EOS was kept: one past the cap is emitted again by the
    # next segment's first forward (the JAX package sets done regardless and
    # drops the tokens up to it: ROADMAP C1)
    st.done.logical_or_(active & any_eos & (n_eos <= room))
    st.seg_steps.add_(active.to(torch.int64))
    st.steps.add_(active.to(torch.int64))


def segment_tokens(st: SpecState, seg: int) -> torch.Tensor:
    """The segment's [seg] tokens, -1 past its emissions (on the device)."""
    toks = st.out_buf[:seg]
    return torch.where(_arange(seg, toks.device) < st.out_n, toks, -1)


def speculative_segment(params, cfg: vitron_model.VitronConfig, state: SpecState,
                        cache: llama.KVCache, seg: int, limit: int, k: int = 4, ngram: int = 2,
                        eos_ids: Tuple[int, ...] = (2,)):
    """The speculative loop for up to min(seg, limit) emitted tokens, run
    eagerly: the loop's condition is read on the host before each forward.
    -> (tokens [seg] with -1 past the end, n_emitted, n_forwards, state);
    `state` and `cache` are updated in place."""
    if state.out_buf.shape[0] < seg + k + 1:
        raise ValueError(f"segment of {seg} > the state's output buffer")
    eos = eos_tensor(eos_ids, state.history.device)
    state.begin_segment(min(seg, int(limit)))
    while bool(state.active()):
        verify_forward(params, cfg, state, cache, k, ngram, eos)
    return (segment_tokens(state, seg), int(state.out_n), int(state.seg_steps), state)


def speculative_loop(params, cfg: vitron_model.VitronConfig, tok0: int, cache: llama.KVCache,
                     index, prompt_ids, seq_len: int, n_new: int, k: int = 4, ngram: int = 2,
                     eos_ids: Tuple[int, ...] = (2,)):
    """The decode loop only (the caller ran the prefill into `cache`, whose
    next slot is `index`; it needs n_new + k + 1 free slots), the whole
    budget as one segment. -> (tokens [n_new] with -1 past the end,
    n_emitted including tok0, n_forwards)."""
    dev = cache.k.device
    state = spec_init_state(tok0, index, prompt_ids, seq_len, n_new, k, eos_ids, device=dev)
    toks, out_n, steps, _ = speculative_segment(params, cfg, state, cache, n_new, n_new - 1,
                                                k=k, ngram=ngram, eos_ids=eos_ids)
    toks = torch.cat([torch.tensor([int(tok0)], device=toks.device), toks])[:n_new]
    toks = torch.where(_arange(n_new, toks.device) < out_n + 1, toks, -1)
    return toks, out_n + 1, steps


@torch.no_grad()
def speculative_decode(params, cfg: vitron_model.VitronConfig, plan_arrays, n_new: int,
                       k: int = 4, ngram: int = 2, eos_ids: Tuple[int, ...] = (2,),
                       images=None, videos=None, max_cache_len: Optional[int] = None):
    """Greedy generation with prompt-lookup speculation: prefill, then
    `speculative_loop`. plan_arrays: (token_ids, media_idx, use_media,
    positions, attn_mask, seq_lens), batch 1, arrays or tensors. -> (tokens
    [n_new] with -1 past the first EOS, n_emitted, n_forwards); tokens per
    forward is n_emitted / n_forwards."""
    token_ids, media_idx, use_media, positions, attn_mask, seq_lens = plan_arrays
    params = promote_int4(params)  # W4A8 leaves when VITRON_W4A8=1, as the JAX entry's
    b, pad_len = np.shape(token_ids)
    if b != 1:
        raise ValueError("speculative_decode is the single-stream path (B=1); "
                         "use PagedServer for batched serving")
    dev = params["llm"]["embed"].device

    def t(a, dtype):
        return (a if torch.is_tensor(a) else torch.as_tensor(np.asarray(a))).to(dev, dtype)

    cache = llama.KVCache.create(cfg.llm, 1, max_len=max_cache_len or (pad_len + n_new + k + 1),
                                 device=dev, kv_heads=llama.local_kv_heads(params["llm"], cfg.llm))
    logits, cache = vitron_model.forward(
        params, cfg, t(token_ids, torch.int64), t(media_idx, torch.int64),
        t(use_media, torch.bool), t(positions, torch.int64), t(attn_mask, torch.bool),
        images=images, videos=videos, cache=cache)
    seq_len = int(np.asarray(seq_lens if not torch.is_tensor(seq_lens) else seq_lens.cpu())[0])
    tok0 = int(logits[0, seq_len - 1].argmax())
    return speculative_loop(params, cfg, tok0, cache, cache.index,
                            np.asarray(token_ids if not torch.is_tensor(token_ids)
                                       else token_ids.cpu())[0],
                            seq_len, n_new, k=k, ngram=ngram, eos_ids=eos_ids)
