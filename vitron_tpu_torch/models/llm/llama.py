"""Llama (Vicuna-7B) decoder in PyTorch.

Port of `vitron_tpu/models/llm/llama.py`. Parameters are a plain dict with
the JAX key paths: per-layer weights stay stacked as [L, in, out] (or as
quantized {"q4","s"} / {"q","s"} dicts of stacked tensors), and the layers
run as a Python loop over `range(num_layers)` that indexes them, so every
weight that reaches a kernel is 2-D and contiguous.

Attention is `attn_impl="xla"` (the einsum path, `_attend_xla`) or
`"flash"`, which sends multi-token calls (prefill, cached chunks, the
speculative verify window of `decode_step`, whose q_offset the kernel reads
on the device) to the hand CUDA flash kernel; single-token decode stays on
the einsum path, as in the JAX package. `"ring"` runs the prefill's
attention over the mesh's `context` axis (`distributed/ring_attention.py`:
B2 with its LSE on each block), given a `mesh`; without one, or with a
cache, it is the einsum path, as in the JAX package.

On a mesh (`runtime/sharded_serving.install_mesh`) the leaves are `Shard`s
placed by `LLAMA_SHARDING_RULES`: each layer all-gathers its fsdp blocks just
before its products, and the attention and MLP run Megatron-split on this
rank's heads and hidden units when their weights are split over `tensor`
(`distributed/tensor_parallel.py`), so the KV cache holds this rank's KV
heads (`local_kv_heads`). In training the input of each split block passes
`tp.copy_to_group`, which sums its gradient over `tensor`.

The no-cache `forward` is differentiable (the trainer's path): the int4
projections and flash attention carry their own `autograd.Function`s, and
`remat=True` recomputes each layer in the backward
(`torch.utils.checkpoint`, the counterpart of the JAX `jax.checkpoint` of
the layer body), which launches each layer's kernels twice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vitron_tpu_torch.core.mesh import FSDP_AXIS, TENSOR_AXIS, gather_params
from vitron_tpu_torch.distributed import tensor_parallel as tp
from vitron_tpu_torch.kernels.flash_attention import flash_attention
from vitron_tpu_torch.kernels.quantization import matmul_maybe_quantized

ATTN_IMPLS = ("xla", "flash", "ring")

# Sharding rules: param-path substring -> spec (JAX's LLAMA_SHARDING_RULES).
# Column-parallel projections split the output dim over `tensor`;
# row-parallel the input dim. `fsdp` shards the complementary dim ZeRO-3
# style. Stacked per-layer weights are [L, in, out] -> the layer dim stays
# unsharded.
LLAMA_SHARDING_RULES = (
    ("embed", (TENSOR_AXIS, FSDP_AXIS)),
    ("wq", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("wk", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("wv", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("wo", (None, TENSOR_AXIS, FSDP_AXIS)),
    ("gate", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("up", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("down", (None, TENSOR_AXIS, FSDP_AXIS)),
    ("lm_head", (FSDP_AXIS, TENSOR_AXIS)),
    ("norm", ()),
)
ATTN_WEIGHTS = (("wq", "wk", "wv"), "wo")
MLP_WEIGHTS = (("gate", "up"), "down")


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
    attn_impl: str = "xla"  # "xla" | "flash" | "ring"
    context_axis: str = "context"  # mesh axis for attn_impl="ring"
    remat: bool = False  # recompute each layer in the backward (no-cache forward only)
    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
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
    fill level (`decode_step` writes at a slot held on the device instead);
    `valid` [B, max_len] marks slots holding real tokens, so right-padded
    rows never attend padding. `forward` mutates the cache and returns the
    same object.
    """

    k: torch.Tensor
    v: torch.Tensor
    index: int
    valid: torch.Tensor

    @staticmethod
    def create(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               device=None, kv_heads: Optional[int] = None) -> "KVCache":
        """kv_heads: this rank's KV heads on a mesh (`local_kv_heads`)."""
        max_len = max_len or cfg.max_seq_len
        shape = (cfg.num_layers, batch, max_len, kv_heads or cfg.num_kv_heads, cfg.head_dim)
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


def _attend(q, k, v, mask, scale, impl: str, kv_mask=None, q_offset=0, mesh=None,
            context_axis: str = "context"):
    """mask: dense [B,1,S,T] (einsum path); kv_mask/q_offset: the flash
    kernel's equivalent (causal in key-slot space + per-slot validity).

    impl="ring" with a mesh (the no-cache prefill only): ring attention
    over `context_axis`, which assumes densely packed rows (no padding
    mask), as the JAX package's does. K/V keep their own KV heads on the
    ring and B2 takes the GQA."""
    if impl == "ring" and q.shape[1] > 1 and mesh is not None:
        from vitron_tpu_torch.distributed.ring_attention import ring_attention

        return ring_attention(q, k, v, mesh, axis_name=context_axis, scale=float(scale),
                              causal=True)
    if impl == "flash" and q.shape[1] > 1:
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               kv_mask=kv_mask, q_offset=q_offset, scale=float(scale))
    return _attend_xla(q, k, v, mask, scale)


def _layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's leaves (dict leaves indexed key by key)."""
    return {name: ({kk: vv[i] for kk, vv in leaf.items()} if isinstance(leaf, dict)
                   else leaf[i]) for name, leaf in layers.items()}


def tp_groups(lp: Dict[str, Any], cfg: LlamaConfig):
    """(attention group, MLP group): the `tensor` process group of each
    block whose weights form the Megatron split (and, for attention, whose
    KV heads divide over it), else None. lp: one layer's leaves or the
    stacked ones."""
    attn = tp.pair_group(lp, *ATTN_WEIGHTS)
    if attn is not None and cfg.num_kv_heads % tp.group_size(attn):
        attn = None
    return attn, tp.pair_group(lp, *MLP_WEIGHTS)


def local_kv_heads(params: Dict[str, Any], cfg: LlamaConfig) -> int:
    """The KV heads this rank's attention (and so its KV cache) holds."""
    layers = params["layers"]
    if not any(tp.sharded(w) for w in layers.values()):
        return cfg.num_kv_heads
    attn, _ = tp_groups(layers, cfg)
    return cfg.num_kv_heads // tp.group_size(attn)


def materialize_layer(lp: Dict[str, Any], cfg: LlamaConfig):
    """One layer's leaves ready for its products -> (leaves, attention
    group, MLP group): plain leaves as they are; on a mesh the fsdp blocks
    all-gathered, and the `tensor` blocks kept where the block runs
    Megatron-split (gathered whole where it cannot)."""
    if not any(tp.sharded(w) for w in lp.values()):
        return lp, None, None
    attn, mlp = tp_groups(lp, cfg)
    split = set(ATTN_WEIGHTS[0] + (ATTN_WEIGHTS[1],)) if attn is not None else set()
    if mlp is not None:
        split |= set(MLP_WEIGHTS[0] + (MLP_WEIGHTS[1],))
    out = {name: tp.gather(w, (TENSOR_AXIS,) if name in split else ())
           for name, w in lp.items()}
    return out, attn, mlp


def forward(params: Dict[str, Any], cfg: LlamaConfig, input_embeds: torch.Tensor,
            positions: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
            cache: Optional[KVCache] = None, mesh=None):
    """Run the decoder -> (logits float32 [B,S,V], cache).

    Without a cache: causal prefill over S. With a cache: writes this
    chunk's K/V at cache.index (in place) and attends over the whole cache
    window; prefill chunks and single-token decode share this path.
    `decode_step` is the single-token step at a device-held slot. `mesh`
    carries the `context` axis of attn_impl="ring".
    """
    b, s, _ = input_embeds.shape
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

    def attend(q, k, v, li):
        if cache is not None:
            cache.k[li, :, start:start + s] = k.to(cache.k.dtype)
            cache.v[li, :, start:start + s] = v.to(cache.v.dtype)
            k, v = cache.k[li], cache.v[li]
        return _attend(q, k, v, mask, scale, cfg.attn_impl, kv_mask=kv_mask, q_offset=q_offset,
                       mesh=mesh if cache is None else None, context_axis=cfg.context_axis)

    def layer(x, lp, li):
        return _block(x, lp, cfg, cos, sin, lambda q, k, v: attend(q, k, v, li))

    layers = params["layers"]
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    for li in range(cfg.num_layers):
        lp = _layer_params(layers, li)
        if remat:
            x = checkpoint(layer, x, lp, li, use_reentrant=False)
        else:
            x = layer(x, lp, li)
    if cache is not None:
        cache.index = start + s
    return _head(params, cfg, x), cache


def decode_step(params: Dict[str, Any], cfg: LlamaConfig, input_embeds: torch.Tensor,
                positions: torch.Tensor, cache: KVCache, index: torch.Tensor):
    """Decode S tokens [B, S, H] at cache slots index + arange(S), the slot
    `index` held in a device tensor ([1] int64) -> (logits float32 [B, S,
    V], cache): the counterpart of the JAX package's cached forward at a
    traced `cache.index`. S = 1 is a decode step; S = k + 1 is the verify
    window of speculative decoding (runtime/speculative.py). K/V are
    written at the slots (`index_copy_`), the validity flags set there, and
    the mask is slot-causal from `index` (query i sees slots <= index + i
    that hold a real token), so the step syncs with no host value,
    allocates only what its shapes fix, and can be captured in a CUDA graph
    and replayed at every position. `cache.index`, the host fill level, is
    left as it is: the caller advances `index`. One token attends on the
    einsum path; a window of more than one takes the flash kernel when
    `attn_impl == "flash"`, with its q_offset read from `index` on the
    device, as the JAX package's window does (`q_offset = cache.index`)."""
    s = input_embeds.shape[1]
    t = cache.k.shape[2]
    x = input_embeds.to(cfg.compute_dtype)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    scale = 1.0 / (cfg.head_dim ** 0.5)
    slots = index if s == 1 else index + torch.arange(s, device=x.device)
    cache.valid.index_fill_(1, slots, True)
    key_pos = torch.arange(t, device=x.device)
    mask = (key_pos[None, :] <= slots[:, None])[None, None] & cache.valid[:, None, None, :]

    def attend(q, k, v, li):
        cache.k[li].index_copy_(1, slots, k.to(cache.k.dtype))
        cache.v[li].index_copy_(1, slots, v.to(cache.v.dtype))
        if cfg.attn_impl == "flash" and s > 1:
            return flash_attention(q.contiguous(), cache.k[li], cache.v[li], kv_mask=cache.valid,
                                   q_offset=index, scale=float(scale))
        return _attend_xla(q, cache.k[li], cache.v[li], mask, scale)

    layers = params["layers"]
    for li in range(cfg.num_layers):
        x = _block(x, _layer_params(layers, li), cfg, cos, sin,
                   lambda q, k, v, li=li: attend(q, k, v, li))
    return _head(params, cfg, x), cache


def _block(x, lp, cfg: LlamaConfig, cos, sin, attend):
    """One decoder layer on x [B, S, H]; attend(q, k, v) gives the attention
    output [B, S, N, D] (and writes the cache where there is one). On a
    mesh q/k/v hold this rank's heads and the row products all-reduce."""
    b, s, h = x.shape
    lp, attn_group, mlp_group = materialize_layer(lp, cfg)
    xn = rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
    if attn_group is not None:
        xn = tp.copy_to_group(xn, attn_group)
    q = matmul_maybe_quantized(xn, lp["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = matmul_maybe_quantized(xn, lp["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = matmul_maybe_quantized(xn, lp["wv"]).reshape(b, s, -1, cfg.head_dim)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    attn_out = attend(q, k, v)
    x = x + tp.row_linear(attn_out.reshape(b, s, -1), lp["wo"], attn_group)
    xn = rms_norm(x, lp["mlp_norm"], cfg.rms_norm_eps)
    if mlp_group is not None:
        xn = tp.copy_to_group(xn, mlp_group)
    gate = F.silu(matmul_maybe_quantized(xn, lp["gate"]))
    return x + tp.row_linear(gate * matmul_maybe_quantized(xn, lp["up"]), lp["down"], mlp_group)


def _head(params, cfg: LlamaConfig, x) -> torch.Tensor:
    x = rms_norm(x, gather_params(params["final_norm"]), cfg.rms_norm_eps)
    return tp.linear(x, params["lm_head"]).to(torch.float32)


def forward_tokens(params, cfg: LlamaConfig, token_ids: torch.Tensor, **kw):
    """Embed token ids, then run `forward`."""
    embeds = params["embed"][token_ids]
    return forward(params, cfg, embeds, **kw)
