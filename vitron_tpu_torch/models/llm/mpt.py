"""MPT decoder backbone (the alternative LM, ALiBi attention), in PyTorch.

Port of `vitron_tpu/models/llm/mpt.py`: pre-LN blocks (layer norm without a
bias, in float32) with packed QKV (`wqkv`), an ALiBi positional bias
instead of RoPE, a GELU MLP with expansion ratio 4 and a head tied to the
token embedding (logits = h @ wte^T); learned positional embeddings (`wpe`)
when ALiBi is off. The param dict has the JAX key paths, per-layer weights
stacked as [L, in, out], and the layers run as a Python loop that indexes
them.

Attention is the einsum with the additive bias, as the JAX code has it
(:164-169); this module has no kernel. Cached decode runs on the port's
`llama.KVCache` (`kv_cache` builds one with MPT's heads), written in place
at `cache.index`, with the bias in slot space: contiguous, unpadded
sequences, where slot == position. `prefix_mask` (prefix-LM mode) is
prefill-only, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from vitron_tpu_torch.models.llm.llama import KVCache


@dataclasses.dataclass(frozen=True)
class MPTConfig:
    vocab_size: int = 50368
    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 24
    expansion_ratio: int = 4
    max_seq_len: int = 2048
    alibi: bool = True
    alibi_bias_max: float = 8.0
    learned_pos_emb: bool = False
    no_bias: bool = True
    layer_norm_eps: float = 1e-5
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    @staticmethod
    def tiny(**kw) -> "MPTConfig":
        base = dict(vocab_size=256, d_model=64, n_heads=4, n_layers=2,
                    max_seq_len=128, param_dtype=torch.float32,
                    compute_dtype=torch.float32)
        base.update(kw)
        return MPTConfig(**base)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def gen_alibi_slopes(n_heads: int, alibi_bias_max: float = 8.0) -> np.ndarray:
    """ALiBi per-head slopes: padded to the next power of two, and for a
    head count that is not one, the odd slopes first, then the even ones,
    cut to n_heads."""
    _n = 2 ** math.ceil(math.log2(n_heads))
    m = np.arange(1, _n + 1, dtype=np.float64) * (alibi_bias_max / _n)
    slopes = 1.0 / (2.0 ** m)
    if _n != n_heads:
        slopes = np.concatenate([slopes[1::2], slopes[0::2]])[:n_heads]
    return slopes.astype(np.float32)


def alibi_bias(n_heads: int, q_pos: torch.Tensor, k_pos: torch.Tensor,
               alibi_bias_max: float = 8.0, full: bool = False) -> torch.Tensor:
    """[H, Sq, Sk] float32 bias = slope * distance: min(k - q, 0) (causal,
    most negative for the most distant key) or, with full=True, -|k - q|
    (the symmetric form of prefix-LM / non-causal mode)."""
    slopes = torch.from_numpy(gen_alibi_slopes(n_heads, alibi_bias_max)).to(q_pos.device)
    diff = (k_pos[None, :] - q_pos[:, None]).to(torch.float32)
    dist = -diff.abs() if full else torch.clamp(diff, max=0.0)
    return slopes[:, None, None] * dist[None]


def init_params(gen: torch.Generator, cfg: MPTConfig, device) -> Dict[str, Any]:
    """Random-init param dict, N(0, 1/fan_in) with fan_in the input dim (the
    JAX init's scales); `gen` lives on `device`."""
    d, l, ffn = cfg.d_model, cfg.n_layers, cfg.d_model * cfg.expansion_ratio
    dt = cfg.param_dtype

    def dense(shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (w * (1.0 / math.sqrt(shape[-2]))).to(dt)

    params = {
        "wte": dense((cfg.vocab_size, d)),
        "layers": {
            "ln1": torch.ones((l, d), dtype=dt, device=device),
            "wqkv": dense((l, d, 3 * d)),
            "wo": dense((l, d, d)),
            "ln2": torch.ones((l, d), dtype=dt, device=device),
            "up": dense((l, d, ffn)),
            "down": dense((l, ffn, d)),
        },
        "norm_f": torch.ones((d,), dtype=dt, device=device),
    }
    if cfg.learned_pos_emb and not cfg.alibi:
        params["wpe"] = dense((cfg.max_seq_len, d))
    return params


def kv_cache(cfg: MPTConfig, batch: int, max_len: int, device=None) -> KVCache:
    """An empty `llama.KVCache` with MPT's layers and heads (every head its
    own K/V head)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                   v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device), index=0,
                   valid=torch.zeros((batch, max_len), dtype=torch.bool, device=device))


def _ln_nobias(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale).to(x.dtype)


def forward(params: Dict[str, Any], cfg: MPTConfig, token_ids: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None,
            prefix_mask: Optional[torch.Tensor] = None):
    """[B, S] -> logits float32 [B, S, V] (tied head).

    Without a cache: causal prefill. With a `llama.KVCache`: writes this
    chunk's K/V at cache.index (in place) and attends the cache window,
    with the ALiBi bias in slot space; returns (logits, cache).
    prefix_mask [B, S] bool: prefix-LM mode, prefill only -- positions
    marked True are attended bidirectionally (the prompt), the rest stay
    causal, and the bias takes its symmetric form."""
    b, s = token_ids.shape
    dev = token_ids.device
    x = params["wte"][token_ids].to(cfg.compute_dtype)
    start = 0 if cache is None else cache.index
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s) + start
    if "wpe" in params:
        x = x + params["wpe"][positions].to(x.dtype)
    if attn_mask is None:
        attn_mask = torch.ones((b, s), dtype=torch.bool, device=dev)
    nh, hd = cfg.n_heads, cfg.head_dim
    scale = 1.0 / (hd ** 0.5)

    if cache is None:
        allowed = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))[None, None]
        if prefix_mask is not None:
            # a query attends any prefix position, or causally
            allowed = allowed | prefix_mask[:, None, None, :]
        mask = allowed & attn_mask[:, None, None, :]
        ar = torch.arange(s, device=dev)
        bias = (alibi_bias(nh, ar, ar, cfg.alibi_bias_max, full=prefix_mask is not None)
                if cfg.alibi else torch.zeros((nh, s, s), device=dev))
    else:
        t = cache.k.shape[2]
        if start + s > t:
            raise ValueError(f"KV cache overflow: {start} + {s} > {t} slots")
        cache.valid[:, start:start + s] = attn_mask
        key_pos = torch.arange(t, device=dev)
        q_pos = start + torch.arange(s, device=dev)
        mask = (key_pos[None, :] <= q_pos[:, None])[None, None] & cache.valid[:, None, None, :]
        bias = (alibi_bias(nh, q_pos, key_pos, cfg.alibi_bias_max) if cfg.alibi
                else torch.zeros((nh, s, t), device=dev))

    def attend(q, k, v):
        logits = torch.einsum("bqnd,bknd->bnqk", q, k).to(torch.float32) * scale
        logits = logits + bias[None]
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        return torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, s, cfg.d_model)

    layers = params["layers"]
    for li in range(cfg.n_layers):
        xn = _ln_nobias(x, layers["ln1"][li], cfg.layer_norm_eps)
        q, k, v = (xn @ layers["wqkv"][li]).reshape(b, s, 3, nh, hd).unbind(2)
        if cache is not None:
            cache.k[li, :, start:start + s] = k.to(cache.k.dtype)
            cache.v[li, :, start:start + s] = v.to(cache.v.dtype)
            k, v = cache.k[li], cache.v[li]
        x = x + attend(q, k, v) @ layers["wo"][li]
        xn = _ln_nobias(x, layers["ln2"][li], cfg.layer_norm_eps)
        x = x + F.gelu(xn @ layers["up"][li], approximate="none") @ layers["down"][li]
    x = _ln_nobias(x, params["norm_f"], cfg.layer_norm_eps)
    logits = (x @ params["wte"].T).to(torch.float32)
    if cache is None:
        return logits
    cache.index = start + s
    return logits, cache


def convert_hf_mpt(state_dict, cfg: MPTConfig, device="cpu") -> Dict[str, Any]:
    """Reference MPT state dict ([transformer.]blocks.{i}.*, wte, norm_f and
    wpe when present) -> the param dict on `device`. Torch tensors become
    float32, numpy arrays keep their type (the JAX `convert_hf_mpt`)."""
    def _t(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.array(v))
        return v.detach().float().cpu()

    sd = {k: _t(v) for k, v in state_dict.items()}
    pfx = "transformer." if any(k.startswith("transformer.") for k in sd) else ""
    l = cfg.n_layers

    def stack_t(fmt):
        return torch.stack([sd[fmt.format(i)].T.contiguous() for i in range(l)]).to(device)

    def stack(fmt):
        return torch.stack([sd[fmt.format(i)] for i in range(l)]).to(device)

    params = {
        "wte": sd[pfx + "wte.weight"].to(device),
        "layers": {
            "ln1": stack(pfx + "blocks.{}.norm_1.weight"),
            "wqkv": stack_t(pfx + "blocks.{}.attn.Wqkv.weight"),
            "wo": stack_t(pfx + "blocks.{}.attn.out_proj.weight"),
            "ln2": stack(pfx + "blocks.{}.norm_2.weight"),
            "up": stack_t(pfx + "blocks.{}.ffn.up_proj.weight"),
            "down": stack_t(pfx + "blocks.{}.ffn.down_proj.weight"),
        },
        "norm_f": sd[pfx + "norm_f.weight"].to(device),
    }
    if (pfx + "wpe.weight") in sd:
        params["wpe"] = sd[pfx + "wpe.weight"].to(device)
    return params
