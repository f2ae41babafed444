"""CLIP text encoder (FrozenCLIPEmbedder, ViT-L/14 text tower).

Port of `vitron_tpu/models/diffusion/clip_text.py`: 12 pre-LN layers,
hidden 768, 12 heads, quick_gelu, causal mask, final LayerNorm; the output
is the last hidden state (`skip_last` layers dropped for the clip-skip
variant). Layer weights are stacked [L, ...] leaves indexed in a Python
loop; attention is the plain einsum form, as in JAX. `convert_hf_clip_text`
(:110) reads an HF or ldm state dict into that tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from vitron_tpu_torch.models.diffusion.layers import lin_w, reading, stack, sub_dict
from vitron_tpu_torch.models.llm.llama import dense_init
from vitron_tpu_torch.models.vision.vit import _layer, layer_norm, quick_gelu


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_length: int = 77
    layer_norm_eps: float = 1e-5

    @staticmethod
    def clip_l(**kw) -> "TextConfig":
        return TextConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "TextConfig":
        base = dict(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, max_length=16)
        base.update(kw)
        return TextConfig(**base)


def init_params(gen: torch.Generator, cfg: TextConfig, device) -> Dict[str, Any]:
    """Random float32 params (N(0, 1/fan_in) weights, zero biases, unit LN)."""
    h, l, ffn = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    f32 = torch.float32

    def stack(shape):
        w = torch.randn((l,) + shape, generator=gen, dtype=f32, device=device)
        return w / math.sqrt(shape[0])

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    def ln():
        return {"scale": torch.ones((l, h), dtype=f32, device=device), "bias": zeros(l, h)}

    return {
        "token_emb": dense_init(gen, (cfg.vocab_size, h), f32, device),
        "pos_emb": dense_init(gen, (cfg.max_length, h), f32, device),
        "layers": {
            "ln1": ln(),
            "attn": {"wq": stack((h, h)), "bq": zeros(l, h), "wk": stack((h, h)),
                     "bk": zeros(l, h), "wv": stack((h, h)), "bv": zeros(l, h),
                     "wo": stack((h, h)), "bo": zeros(l, h)},
            "ln2": ln(),
            "fc1": stack((h, ffn)), "b1": zeros(l, ffn),
            "fc2": stack((ffn, h)), "b2": zeros(l, h),
        },
        "final_ln": {"scale": torch.ones((h,), dtype=f32, device=device), "bias": zeros(h)},
    }


def _causal_mha(x, p, num_heads):
    b, n, h = x.shape
    d = h // num_heads
    q = (x @ p["wq"] + p["bq"]).reshape(b, n, num_heads, d)
    k = (x @ p["wk"] + p["bk"]).reshape(b, n, num_heads, d)
    v = (x @ p["wv"] + p["bv"]).reshape(b, n, num_heads, d)
    logits = torch.einsum("bqnd,bknd->bnqk", q, k).to(torch.float32) / math.sqrt(d)
    causal = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    logits = torch.where(causal[None, None], logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(b, n, h)
    return out @ p["wo"] + p["bo"]


def encode(params: Dict[str, Any], cfg: TextConfig, token_ids: torch.Tensor,
           skip_last: int = 0) -> torch.Tensor:
    """token_ids [B, L] -> [B, L, hidden]; skip_last=1 gives the penultimate
    hidden state (final LN still applied)."""
    x = params["token_emb"][token_ids]
    x = x + params["pos_emb"][: x.shape[1]]
    for i in range(cfg.num_layers - skip_last):
        lp = _layer(params["layers"], i)
        x = x + _causal_mha(layer_norm(x, lp["ln1"], cfg.layer_norm_eps), lp["attn"],
                            cfg.num_heads)
        xn = layer_norm(x, lp["ln2"], cfg.layer_norm_eps)
        x = x + quick_gelu(xn @ lp["fc1"] + lp["b1"]) @ lp["fc2"] + lp["b2"]
    return layer_norm(x, params["final_ln"], cfg.layer_norm_eps)


def convert_hf_clip_text(state_dict, cfg: TextConfig, prefix: str = "text_model.",
                         device="cpu") -> Dict[str, Any]:
    """HF CLIPTextModel state dict -> the stacked param tree on `device`.
    Also takes ldm's FrozenCLIPEmbedder prefixes: 'transformer.text_model.'
    (the GLIGEN bundle's `text_encoder`) and
    'cond_stage_model.transformer.text_model.' (a ControlLDM bundle)."""
    for cand in ("cond_stage_model.transformer.text_model.", "transformer.text_model.", prefix):
        if any(k.startswith(cand) for k in state_dict):
            prefix = cand
            break
    sd = sub_dict(reading(state_dict, device), prefix)
    l = cfg.num_layers

    def stack_t(fmt):
        return stack([lin_w(sd, fmt.format(i)) for i in range(l)])

    def stack_(fmt):
        return stack([sd[fmt.format(i)] for i in range(l)])

    return {
        "token_emb": sd["embeddings.token_embedding.weight"],
        "pos_emb": sd["embeddings.position_embedding.weight"],
        "layers": {
            "ln1": {"scale": stack_("encoder.layers.{}.layer_norm1.weight"),
                    "bias": stack_("encoder.layers.{}.layer_norm1.bias")},
            "attn": {
                "wq": stack_t("encoder.layers.{}.self_attn.q_proj.weight"),
                "bq": stack_("encoder.layers.{}.self_attn.q_proj.bias"),
                "wk": stack_t("encoder.layers.{}.self_attn.k_proj.weight"),
                "bk": stack_("encoder.layers.{}.self_attn.k_proj.bias"),
                "wv": stack_t("encoder.layers.{}.self_attn.v_proj.weight"),
                "bv": stack_("encoder.layers.{}.self_attn.v_proj.bias"),
                "wo": stack_t("encoder.layers.{}.self_attn.out_proj.weight"),
                "bo": stack_("encoder.layers.{}.self_attn.out_proj.bias"),
            },
            "ln2": {"scale": stack_("encoder.layers.{}.layer_norm2.weight"),
                    "bias": stack_("encoder.layers.{}.layer_norm2.bias")},
            "fc1": stack_t("encoder.layers.{}.mlp.fc1.weight"),
            "b1": stack_("encoder.layers.{}.mlp.fc1.bias"),
            "fc2": stack_t("encoder.layers.{}.mlp.fc2.weight"),
            "b2": stack_("encoder.layers.{}.mlp.fc2.bias"),
        },
        "final_ln": {"scale": sd["final_layer_norm.weight"],
                     "bias": sd["final_layer_norm.bias"]},
    }
