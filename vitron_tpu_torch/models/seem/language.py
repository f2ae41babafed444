"""SEEM language encoder: CLIP-tokenized causal transformer + projection.

Port of `vitron_tpu/models/seem/language.py` (:24-184), the reference
LanguageEncoder (modules/SEEM/demo_code/xdecoder/language/vlpencoder.py:
150-304, LangEncoder/transformer.py:77-160; width 512, 12 layers, 8 heads,
context 77, causal): pre-LN residual blocks with QuickGELU and LayerNorm eps
1e-12; the pooled feature is the final-LN hidden state at argmax(token id)
(the EOT), projected by lang_proj. The JAX `lax.scan` over the stacked
layers is a loop here. The checkpoint converter waits for the SEEM weights.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from vitron_tpu_torch.models.vision.vit import layer_norm, quick_gelu


@dataclasses.dataclass(frozen=True)
class LangConfig:
    vocab_size: int = 49408
    width: int = 512
    num_layers: int = 12
    num_heads: int = 8
    context_length: int = 77
    dim_proj: int = 512
    autoregressive: bool = True
    # the vendored LangEncoder LayerNorm uses eps=1e-12 (transformer.py:55)
    layer_norm_eps: float = 1e-12

    @staticmethod
    def tiny(**kw) -> "LangConfig":
        base = dict(vocab_size=128, width=32, num_layers=2, num_heads=4,
                    context_length=16, dim_proj=32)
        base.update(kw)
        return LangConfig(**base)


PROMPT_TEMPLATES = [
    "a photo of a {}.",
    "This is a photo of a {}",
    "There is a {} in the scene",
    "There is the {} in the scene",
    "a photo of a {} in the scene",
    "a photo of a small {}.",
    "a photo of a medium {}.",
    "a photo of a large {}.",
    "a photo of the {}.",
    "a photo of the small {}.",
    "a photo of the medium {}.",
    "a photo of the large {}.",
]


def init_params(gen: torch.Generator, cfg: LangConfig, device) -> Dict[str, Any]:
    """Random-init param tree (layers stacked on a leading axis, as in the
    JAX package)."""
    w, l = cfg.width, cfg.num_layers

    def dense(shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def ln():
        return {"scale": torch.ones((l, w), device=device),
                "bias": torch.zeros((l, w), device=device)}

    return {
        "token_emb": dense((cfg.vocab_size, w)),
        "pos_emb": dense((cfg.context_length, w)),
        "layers": {
            "ln1": ln(),
            "attn": {"in_w": dense((l, w, 3 * w)), "in_b": torch.zeros((l, 3 * w), device=device),
                     "out_w": dense((l, w, w)), "out_b": torch.zeros((l, w), device=device)},
            "ln2": ln(),
            "fc1": dense((l, w, 4 * w)), "b1": torch.zeros((l, 4 * w), device=device),
            "fc2": dense((l, 4 * w, w)), "b2": torch.zeros((l, w), device=device),
        },
        "ln_final": {"scale": torch.ones((w,), device=device),
                     "bias": torch.zeros((w,), device=device)},
        "lang_proj": dense((w, cfg.dim_proj)),
        "logit_scale": torch.zeros((), device=device),
    }


def _block(x, lp, heads, causal, eps):
    b, n, w = x.shape
    d = w // heads
    xn = layer_norm(x, lp["ln1"], eps)
    wq, wk, wv = lp["attn"]["in_w"].chunk(3, dim=1)
    bq, bk, bv = lp["attn"]["in_b"].chunk(3, dim=0)
    q = (xn @ wq + bq).reshape(b, n, heads, d)
    k = (xn @ wk + bk).reshape(b, n, heads, d)
    v = (xn @ wv + bv).reshape(b, n, heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / math.sqrt(d)
    if causal:
        mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, n, w)
    x = x + att @ lp["attn"]["out_w"] + lp["attn"]["out_b"]
    h = quick_gelu(layer_norm(x, lp["ln2"], eps) @ lp["fc1"] + lp["b1"])
    return x + h @ lp["fc2"] + lp["b2"]


def _layer(tree, i):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def encode_tokens(params, cfg: LangConfig, token_ids: torch.Tensor) -> torch.Tensor:
    """[B, 77] -> last hidden state [B, 77, width] (post ln_final)."""
    x = params["token_emb"][token_ids]
    x = x + params["pos_emb"][: x.shape[1]]
    for i in range(cfg.num_layers):
        x = _block(x, _layer(params["layers"], i), cfg.num_heads, cfg.autoregressive,
                   cfg.layer_norm_eps)
    return layer_norm(x, params["ln_final"], cfg.layer_norm_eps)


def _normalize(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-7)


def token_and_class_emb(params, cfg: LangConfig, token_ids: torch.Tensor, norm: bool = False):
    """forward_language_token (vlpencoder.py:275-291): projected per-token
    embeddings + pooled class embedding at EOT."""
    hidden = encode_tokens(params, cfg, token_ids)
    eot = torch.argmax(token_ids, dim=-1)
    class_x = hidden[torch.arange(hidden.shape[0], device=hidden.device), eot]
    token_x = hidden @ params["lang_proj"]
    class_x = class_x @ params["lang_proj"]
    if norm:
        token_x, class_x = _normalize(token_x), _normalize(class_x)
    return token_x, class_x


def class_embeddings(params, cfg: LangConfig, tokenizer, class_names: Sequence[str],
                     templates: Sequence[str] = tuple(PROMPT_TEMPLATES)) -> torch.Tensor:
    """Prompt-ensembled class embedding cache (vlpencoder.py:219-244): mean
    over templates, normalized, one class at a time. -> [n_cls, dim_proj]."""
    device = params["token_emb"].device
    out = []
    for cls in class_names:
        name = cls.replace("-other", "").replace("-merged", "").replace("-stuff", "")
        ids = tokenize(tokenizer, [t.format(name) for t in templates], cfg.context_length)
        _, emb = token_and_class_emb(params, cfg, torch.as_tensor(ids, device=device), norm=True)
        mean = emb.mean(dim=0)
        out.append(mean / (torch.linalg.vector_norm(mean) + 1e-7))
    return torch.stack(out)


def class_prompt_ids(tokenizer, class_names: Sequence[str], cfg: LangConfig,
                     templates: Sequence[str] = None) -> Tuple[np.ndarray, int]:
    """Host half of the class-bank build: tokenize every class x template
    prompt at once -> ([n_cls * T, 77] ids, T)."""
    templates = tuple(templates) if templates else tuple(PROMPT_TEMPLATES)
    names = [c.replace("-other", "").replace("-merged", "").replace("-stuff", "")
             for c in class_names]
    txts = [t.format(n) for n in names for t in templates]
    return tokenize(tokenizer, txts, cfg.context_length), len(templates)


def class_embeddings_from_ids(params, cfg: LangConfig, ids: torch.Tensor,
                              n_templates: int) -> torch.Tensor:
    """Device half: prompt-ensembled mean per class, normalized, all
    prompts in one batch. -> [n_cls, dim_proj]."""
    _, emb = token_and_class_emb(params, cfg, ids, norm=True)
    return _normalize(emb.reshape(-1, n_templates, emb.shape[-1]).mean(dim=1))


def tokenize(tokenizer, texts: List[str], max_length: int) -> np.ndarray:
    t = tokenizer(texts, padding="max_length", truncation=True, max_length=max_length,
                  return_tensors="np")
    return t["input_ids"]


def vl_similarity(image_feat: torch.Tensor, text_feat: torch.Tensor,
                  logit_scale: torch.Tensor) -> torch.Tensor:
    """exp(logit_scale) * t @ v^T (tasks/interactive.py:162-175)."""
    return torch.exp(logit_scale) * text_feat @ image_feat.T
