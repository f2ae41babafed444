"""Autoregressive generation: multimodal prefill + KV-cached decode.

Port of the plain path of `vitron_tpu/runtime/generation.py::Generator`:
one prefill over the spliced embeddings into a preallocated KV cache, then
single-token decode steps; sampling is greedy or temperature + top-p with a
`torch.Generator`; stopping is EOS ids plus the host-side `KeywordStopper`,
checked at the same points as the JAX package (every `STOP_CHECK_EVERY`
steps on the per-token path, at every emitted position on the chunked path).

The chunked path keeps a chunk's tokens on the device and copies them to
the host once per chunk. Speculative decoding is not ported: it waits on
the reference fault C1 (ROADMAP), so `speculative=True` raises and
`speculative=None` never speculates. There is no `generate_scan`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.models.llm import llama


STOP_CHECK_EVERY = 8  # per-token path: keyword-stop check interval, as in the JAX package


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.2
    top_p: float = 0.7
    max_new_tokens: int = 1024
    greedy: bool = False
    eos_ids: tuple = (2,)


def has_packed_int4(params) -> bool:
    """True if any leaf dict is a packed-int4 weight ({'q4', 's'})."""
    if isinstance(params, dict):
        return "q4" in params or any(has_packed_int4(v) for v in params.values())
    return False


def sample_token(logits: torch.Tensor, temperature: float, top_p: float, greedy: bool,
                 gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits [B, V] -> token ids [B] (int64). Nucleus (top-p) + temperature;
    the top-1 token is always kept."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class Generator:
    """Prefill + decode for one model; call `generate` per planned batch."""

    def __init__(self, params: Dict[str, Any], cfg: vitron_model.VitronConfig, device=None):
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device) if device is not None else \
            params["llm"]["embed"].device
        self.last_prefill_logits: Optional[torch.Tensor] = None  # [B, V] float32

    def _t(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device, dtype=dtype)

    @torch.no_grad()
    def generate(self, plan, images: Optional[torch.Tensor] = None,
                 videos: Optional[torch.Tensor] = None,
                 block_perm: Optional[np.ndarray] = None,
                 region_boxes: Optional[np.ndarray] = None,
                 sampling: SamplingConfig = SamplingConfig(),
                 gen: Optional[torch.Generator] = None, stopper=None,
                 decode_chunk: Optional[int] = None,
                 speculative: Optional[bool] = None) -> List[List[int]]:
        """Run prefill + decode for one planned batch; returns the new token
        ids per row. decode_chunk: None = 128 for packed-int4 weights,
        per-token stepping otherwise; 0 forces per-token stepping.
        `gen` drives sampling (a generator on the model's device)."""
        if speculative:
            raise NotImplementedError(
                "speculative decoding is not ported: it waits on fault C1 (ROADMAP)")
        cfg, params = self.cfg, self.params
        b, pad_len = plan.token_ids.shape
        if decode_chunk is None and has_packed_int4(params):
            decode_chunk = 128
        cache = llama.KVCache.create(cfg.llm, b, max_len=pad_len + sampling.max_new_tokens,
                                     device=self.device)

        kwargs: Dict[str, Any] = {}
        if plan.region_blocks is not None and len(plan.region_blocks) and region_boxes is not None:
            kwargs["region_boxes"] = self._t(region_boxes, torch.float32)
            kwargs["region_block_idx"] = self._t(plan.region_blocks, torch.int64)
        if block_perm is not None:
            kwargs["block_perm"] = self._t(block_perm, torch.int64)
        logits, cache = vitron_model.forward(
            params, cfg,
            plan_token_ids=self._t(plan.token_ids, torch.int64),
            plan_media_idx=self._t(plan.media_idx, torch.int64),
            plan_use_media=self._t(plan.use_media, torch.bool),
            positions=self._t(plan.position_ids, torch.int64),
            attn_mask=self._t(plan.attention_mask, torch.bool),
            images=images, videos=videos, cache=cache, **kwargs)
        # next-token logits live at each row's last REAL position
        last = self._t(plan.seq_lens - 1, torch.int64)
        next_logits = logits[torch.arange(b, device=self.device), last]
        token = sample_token(next_logits, sampling.temperature, sampling.top_p,
                             sampling.greedy, gen)[:, None]
        self.last_prefill_logits = next_logits

        out_tokens: List[List[int]] = [[] for _ in range(b)]
        done = np.zeros(b, bool)
        pos = self._t(plan.seq_lens, torch.int64)[:, None]
        if decode_chunk:
            return self._generate_chunked(token, pos, cache, out_tokens, done, gen,
                                          sampling, stopper, decode_chunk)

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
            token = self._decode(token, pos, cache, sampling, gen)
            pos = pos + 1
        return out_tokens

    def _decode(self, token, pos, cache, sampling: SamplingConfig, gen) -> torch.Tensor:
        logits, _ = vitron_model.decode_step(self.params, self.cfg, token, pos, cache)
        return sample_token(logits[:, -1], sampling.temperature, sampling.top_p,
                            sampling.greedy, gen)[:, None]

    def _generate_chunked(self, token, pos, cache, out_tokens, done, gen,
                          sampling: SamplingConfig, stopper, chunk: int):
        """Decode up to `chunk` tokens per round on the device (the chunk's
        tokens stay there and reach the host in one copy), then apply EOS and
        the stopper at every emitted position on the host."""
        b = len(out_tokens)
        tok_host = token[:, 0].cpu().numpy()
        for i in range(b):  # the prefill-sampled first token
            out_tokens[i].append(int(tok_host[i]))
            if int(tok_host[i]) in sampling.eos_ids:
                done[i] = True
            elif stopper is not None and stopper.should_stop(out_tokens[i]):
                done[i] = True
        produced = 1
        while produced < sampling.max_new_tokens and not done.all():
            n = min(chunk, sampling.max_new_tokens - produced)
            buf = torch.empty((b, n), dtype=torch.int64, device=self.device)
            for j in range(n):
                token = self._decode(token, pos, cache, sampling, gen)
                pos = pos + 1
                buf[:, j] = token[:, 0]
            buf_host = buf.cpu().numpy()
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
