"""CLIP ViT vision tower (image) + LanguageBind temporal variant (video).

Port of `vitron_tpu/models/vision/vit.py`: ViT-L/14 at 224x224, pre-LN,
quick_gelu MLP; the image feature is hidden_states[select_layer][:, 1:], so
only `num_layers + 1 + select_layer` layers run (23 for ViT-L);
`forward_pooled` runs all of them for CLIP's pooled embedding (GLIGEN's
style features). The video
tower adds, per layer, a temporal position embedding and temporal
self-attention over the frame axis before the spatial attention. Layers are
stacked [L, ...] leaves indexed in a Python loop; attention is the plain
einsum form (the JAX package did not use a kernel here).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from vitron_tpu_torch.core.mesh import FSDP_AXIS, TENSOR_AXIS
from vitron_tpu_torch.models.llm.llama import dense_init


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    select_layer: int = -2       # index into [embeds, layer1, ..., layerL]
    add_time_attn: bool = False  # video tower
    num_frames: int = 8
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def clip_vit_l14(**kw) -> "ViTConfig":
        return ViTConfig(**kw)

    @staticmethod
    def video_vit_l14(**kw) -> "ViTConfig":
        kw.setdefault("add_time_attn", True)
        return ViTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        base = dict(image_size=28, patch_size=7, hidden_size=32, num_layers=3,
                    num_heads=4, intermediate_size=64, num_frames=4)
        base.update(kw)
        return ViTConfig(**base)


# Stacked per-layer weights are [L, in, out]; biases and norms replicate
# (JAX's VIT_SHARDING_RULES). A sharded tower is gathered whole before it
# runs (`vitron_model.encode_media`).
VIT_SHARDING_RULES = (
    ("patch_proj", (None, TENSOR_AXIS)),
    ("pos_emb", ()),
    ("t_emb", ()),
    ("wq", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("wk", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("wv", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("wo", (None, TENSOR_AXIS, FSDP_AXIS)),
    ("fc1", (None, FSDP_AXIS, TENSOR_AXIS)),
    ("fc2", (None, TENSOR_AXIS, FSDP_AXIS)),
)


def _attn_block_init(gen, h, l, dtype, device):
    out = {}
    for name in ("q", "k", "v", "o"):
        out["w" + name] = dense_init(gen, (l, h, h), dtype, device)
        out["b" + name] = torch.zeros((l, h), dtype=dtype, device=device)
    return out


def _ln_init(shape, dtype, device):
    return {"scale": torch.ones(shape, dtype=dtype, device=device),
            "bias": torch.zeros(shape, dtype=dtype, device=device)}


def init_params(gen: torch.Generator, cfg: ViTConfig, device) -> Dict[str, Any]:
    h, l, ffn = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    pdim = cfg.patch_size * cfg.patch_size * 3
    dt = cfg.param_dtype
    layers = {
        "ln1": _ln_init((l, h), dt, device),
        "attn": _attn_block_init(gen, h, l, dt, device),
        "ln2": _ln_init((l, h), dt, device),
        "fc1": dense_init(gen, (l, h, ffn), dt, device),
        "b1": torch.zeros((l, ffn), dtype=dt, device=device),
        "fc2": dense_init(gen, (l, ffn, h), dt, device),
        "b2": torch.zeros((l, h), dtype=dt, device=device),
    }
    if cfg.add_time_attn:
        t_emb = torch.randn((l, cfg.num_frames, h), generator=gen, device=device)
        layers["t_emb"] = (t_emb * h ** -0.5).to(dt)
        layers["t_ln"] = _ln_init((l, h), dt, device)
        layers["t_attn"] = _attn_block_init(gen, h, l, dt, device)
    return {
        "class_emb": dense_init(gen, (h,), dt, device),
        "patch_proj": dense_init(gen, (pdim, h), dt, device),
        "pos_emb": dense_init(gen, (cfg.num_patches + 1, h), dt, device),
        "pre_ln": _ln_init((h,), dt, device),
        "layers": layers,
        "post_ln": _ln_init((h,), dt, device),
    }


def layer_norm(x, p, eps):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)).to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _mha(x, p, num_heads):
    """Bidirectional multi-head attention with a float32 softmax. x: [B, N, H]."""
    b, n, h = x.shape
    d = h // num_heads
    q = (x @ p["wq"] + p["bq"]).reshape(b, n, num_heads, d)
    k = (x @ p["wk"] + p["bk"]).reshape(b, n, num_heads, d)
    v = (x @ p["wv"] + p["bv"]).reshape(b, n, num_heads, d)
    logits = torch.einsum("bqnd,bknd->bnqk", q, k).to(torch.float32) / math.sqrt(d)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, n, h)
    return out @ p["wo"] + p["bo"]


def patchify(pixels: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, 3] -> [B, N, P*P*3] patch rows (ph, pw, c ordering)."""
    b, hh, ww, c = pixels.shape
    p = cfg.patch_size
    x = pixels.reshape(b, hh // p, p, ww // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hh // p) * (ww // p), p * p * c)


def embed(params, cfg: ViTConfig, pixels):
    """[B, H, W, 3] -> [B, N+1, H] (CLS + patches + position embeddings)."""
    x = patchify(pixels.to(cfg.compute_dtype), cfg) @ params["patch_proj"]
    if "patch_bias" in params:
        x = x + params["patch_bias"].to(x.dtype)
    cls = params["class_emb"].to(x.dtype).expand(x.shape[0], 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    return x + params["pos_emb"].to(x.dtype)


def _num_run_layers(cfg: ViTConfig) -> int:
    """hidden_states[select_layer] is produced after this many layers."""
    sel = cfg.select_layer
    return cfg.num_layers + 1 + sel if sel < 0 else sel


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _spatial_block(x, lp, cfg: ViTConfig):
    x = x + _mha(layer_norm(x, lp["ln1"], cfg.layer_norm_eps), lp["attn"], cfg.num_heads)
    xn = layer_norm(x, lp["ln2"], cfg.layer_norm_eps)
    return x + quick_gelu(xn @ lp["fc1"] + lp["b1"]) @ lp["fc2"] + lp["b2"]


def forward_features(params, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Image tower: [B, H, W, 3] -> [B, num_patches, hidden] patch features."""
    x = embed(params, cfg, pixels)
    x = layer_norm(x, params["pre_ln"], cfg.layer_norm_eps)
    for i in range(_num_run_layers(cfg)):
        x = _spatial_block(x, _layer(params["layers"], i), cfg)
    return x[:, 1:]  # drop CLS


def forward_pooled(params, cfg: ViTConfig, pixels: torch.Tensor,
                   visual_proj: torch.Tensor = None) -> torch.Tensor:
    """CLIP pooled image embedding: every layer runs (not `_num_run_layers`),
    then the post-LN CLS token and the optional visual projection.
    [B, H, W, 3] -> [B, hidden] or [B, proj]."""
    x = embed(params, cfg, pixels)
    x = layer_norm(x, params["pre_ln"], cfg.layer_norm_eps)
    for i in range(cfg.num_layers):
        x = _spatial_block(x, _layer(params["layers"], i), cfg)
    pooled = layer_norm(x[:, 0], params["post_ln"], cfg.layer_norm_eps)
    return pooled if visual_proj is None else pooled @ visual_proj


def forward_video_features(params, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Video tower: [B, T, H, W, 3] -> [B, T, num_patches, hidden]."""
    b, t = pixels.shape[:2]
    x = embed(params, cfg, pixels.reshape((b * t,) + tuple(pixels.shape[2:])))
    x = layer_norm(x, params["pre_ln"], cfg.layer_norm_eps)
    n_tok, h = x.shape[1], cfg.hidden_size
    for i in range(_num_run_layers(cfg)):
        lp = _layer(params["layers"], i)
        if cfg.add_time_attn:
            # temporal: [(b t), n, d] -> [(b n), t, d]
            xt = x.reshape(b, t, n_tok, h).transpose(1, 2).reshape(b * n_tok, t, h)
            if t != 1:
                xt = xt + lp["t_emb"][:t].to(x.dtype)
            xt = xt + _mha(layer_norm(xt, lp["t_ln"], cfg.layer_norm_eps), lp["t_attn"],
                           cfg.num_heads)
            x = xt.reshape(b, n_tok, t, h).transpose(1, 2).reshape(b * t, n_tok, h)
        x = _spatial_block(x, lp, cfg)
    return x[:, 1:].reshape(b, t, n_tok - 1, h)


def fold_normalization_into_patch_proj(params, cfg: ViTConfig, mean, std) -> Dict[str, Any]:
    """Fold `(x / 255 - mean) / std` into the patch projection, so the tower
    takes raw [0, 255] pixels: per-channel scale a = 1 / (255 std) folded
    into patch_proj's input rows (ordered (ph, pw, c)) and the shift
    -mean / std folded into a new "patch_bias" [hidden], which `embed` adds
    when present (the JAX `fold_normalization_into_patch_proj`)."""
    w = params["patch_proj"].to(torch.float32)  # [(P*P*3), H]
    p = cfg.patch_size
    mean = torch.as_tensor(mean, dtype=torch.float32, device=w.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=w.device)
    a = 1.0 / std / 255.0
    shift = -mean / std
    folded = (w.reshape(p * p, 3, cfg.hidden_size) * a[None, :, None]).reshape(
        p * p * 3, cfg.hidden_size)
    bias = (shift.repeat(p * p)[None] @ w).reshape(-1)
    dt = params["patch_proj"].dtype
    return {**params, "patch_proj": folded.to(dt), "patch_bias": bias.to(dt)}
