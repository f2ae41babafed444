"""Llama (Vicuna-7B) decoder in PyTorch.

Port of `vitron_tpu/models/llm/llama.py`. Parameters are a plain dict with
the JAX key paths: per-layer weights stay stacked as [L, in, out] (or as
quantized {"q4","s"} / {"q","s"} dicts of stacked tensors), and the layers
run as a Python loop over `range(num_layers)` that indexes them, so every
weight that reaches a kernel is 2-D and contiguous.

Attention is `attn_impl="xla"` (the einsum path, `_attend_xla`) or
`"flash"`, which sends multi-token calls (prefill, cached chunks) to the
hand CUDA flash kernel; single-token decode stays on the einsum path, as in
the JAX package. `"ring"` is not ported yet (ROADMAP A16).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels.flash_attention import flash_attention
from vitron_tpu_torch.kernels.quantization import matmul_maybe_quantized

ATTN_IMPLS = ("xla", "flash")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_seq_len: int = 4096
    attn_impl: str = "xla"  # "xla" | "flash"
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.attn_impl == "ring":
            raise NotImplementedError("attn_impl='ring' is not ported yet (ROADMAP A16)")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def vicuna_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Small config for CPU tests."""
        base = dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=4, max_seq_len=128,
            param_dtype=torch.float32, compute_dtype=torch.float32,
        )
        base.update(kw)
        return LlamaConfig(**base)


def dense_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    """N(0, 1/fan_in) init, fan_in = shape[0] (the JAX package's rule)."""
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / shape[0] ** 0.5)).to(dtype)


def init_params(gen: torch.Generator, cfg: LlamaConfig, device) -> Dict[str, Any]:
    """Random-init param dict (tests, smoke runs); `gen` lives on `device`."""
    h, ffn, l = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    kvd = cfg.num_kv_heads * cfg.head_dim
    dt = cfg.param_dtype

    def stack(shape):
        return dense_init(gen, (l,) + shape, dt, device)

    return {
        "embed": dense_init(gen, (cfg.vocab_size, h), dt, device),
        "layers": {
            "attn_norm": torch.ones((l, h), dtype=dt, device=device),
            "wq": stack((h, h)),
            "wk": stack((h, kvd)),
            "wv": stack((h, kvd)),
            "wo": stack((h, h)),
            "mlp_norm": torch.ones((l, h), dtype=dt, device=device),
            "gate": stack((h, ffn)),
            "up": stack((h, ffn)),
            "down": stack((ffn, h)),
        },
        "final_norm": torch.ones((h,), dtype=dt, device=device),
        "lm_head": dense_init(gen, (h, cfg.vocab_size), dt, device),
    }


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return x32.to(dt) * w.to(dt)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for positions [B, S] -> [B, S, head_dim] float32."""
    ar = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (ar / head_dim))
    freqs = positions[..., None].to(torch.float32) * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, N, D]; cos/sin: [B, S, D]. HF rotate_half convention."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return x * c + rotated * s


@dataclasses.dataclass
class KVCache:
    """Preallocated KV cache, updated IN PLACE.

    k/v: [L, B, max_len, num_kv_heads, head_dim] buffers that `forward`
    writes by slice assignment at `index` (the counterpart of the JAX
    package's single-slot dynamic_update_slice); `index` is the host-side
    fill level; `valid` [B, max_len] marks slots holding real tokens, so
    right-padded rows never attend padding. `forward` mutates the cache and
    returns the same object.
    """

    k: torch.Tensor
    v: torch.Tensor
    index: int
    valid: torch.Tensor

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               device=None) -> "KVCache":
        max_len = max_len or cfg.max_seq_len
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            v=torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            index=0,
            valid=torch.zeros((batch, max_len), dtype=torch.bool, device=device),
        )


def _attend_xla(q, k, v, mask, scale):
    """Einsum attention: [B,S,N,D] x [B,T,K,D] with a float32 softmax.
    mask: bool [B, 1, S, T] (True = attend)."""
    b, s, n, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    groups = n // kv_heads
    q = q.reshape(b, s, kv_heads, groups, d)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).to(torch.float32) * scale
    logits = logits.reshape(b, n, s, t)
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    probs = probs.reshape(b, kv_heads, groups, s, t)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, n, d)


def _attend(q, k, v, mask, scale, impl: str, kv_mask=None, q_offset=0):
    """mask: dense [B,1,S,T] (einsum path); kv_mask/q_offset: the flash
    kernel's equivalent (causal in key-slot space + per-slot validity)."""
    if impl == "flash" and q.shape[1] > 1:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               kv_mask=kv_mask, q_offset=q_offset, scale=float(scale))
    return _attend_xla(q, k, v, mask, scale)


def _layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's leaves (dict leaves indexed key by key)."""
    return {name: ({kk: vv[i] for kk, vv in leaf.items()} if isinstance(leaf, dict)
                   else leaf[i]) for name, leaf in layers.items()}


def forward(params: Dict[str, Any], cfg: LlamaConfig, input_embeds: torch.Tensor,
            positions: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None):
    """Run the decoder -> (logits float32 [B,S,V], cache).

    Without a cache: causal prefill over S. With a cache: writes this
    chunk's K/V at cache.index (in place) and attends over the whole cache
    window; prefill chunks and single-token decode share this path.
    """
    b, s, h = input_embeds.shape
    x = input_embeds.to(cfg.compute_dtype)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    dev = x.device
    if attn_mask is None:
        attn_mask = torch.ones((b, s), dtype=torch.bool, device=dev)

    if cache is None:
        causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
        mask = causal[None, None] & attn_mask[:, None, None, :]
        kv_mask, q_offset = attn_mask.contiguous(), 0
    else:
        t = cache.k.shape[2]
        start = cache.index
        if start + s > t:
            raise ValueError(f"KV cache overflow: {start} + {s} > {t} slots")
        cache.valid[:, start:start + s] = attn_mask
        key_pos = torch.arange(t, device=dev)[None, None, None, :]
        q_pos = start + torch.arange(s, device=dev)[None, None, :, None]
        mask = (key_pos <= q_pos) & cache.valid[:, None, None, :]
        kv_mask, q_offset = cache.valid, start

    layers = params["layers"]
    for li in range(cfg.num_layers):
        lp = _layer_params(layers, li)
        xn = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q = matmul_maybe_quantized(xn, lp["wq"]).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = matmul_maybe_quantized(xn, lp["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = matmul_maybe_quantized(xn, lp["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cache is not None:
            cache.k[li, :, start:start + s] = k.to(cache.k.dtype)
            cache.v[li, :, start:start + s] = v.to(cache.v.dtype)
            k, v = cache.k[li], cache.v[li]
        attn_out = _attend(q, k, v, mask, scale, cfg.attn_impl, kv_mask=kv_mask,
                           q_offset=q_offset)
        x = x + matmul_maybe_quantized(attn_out.reshape(b, s, h), lp["wo"])
        xn = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
        gate = F.silu(matmul_maybe_quantized(xn, lp["gate"]))
        x = x + matmul_maybe_quantized(gate * matmul_maybe_quantized(xn, lp["up"]), lp["down"])
    if cache is not None:
        cache.index = start + s

    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = matmul_maybe_quantized(x, params["lm_head"]).to(torch.float32)
    return logits, cache


def forward_tokens(params, cfg: LlamaConfig, token_ids: torch.Tensor, **kw):
    """Embed token ids, then run `forward`."""
    embeds = params["embed"][token_ids]
    return forward(params, cfg, embeds, **kw)
