"""HF CLIP / LanguageBind vision checkpoint conversion, in PyTorch.

Port of `vitron_tpu/models/vision/loader.py`: maps an HF `CLIPVisionModel`
state dict (and the LanguageBind video variant, whose layers add
`temporal_embedding`, `temporal_layer_norm1` and `temporal_attn`) onto the
stacked-layer param dict of `models/vision/vit.py`, each leaf cast through
float32 to the config's param dtype, as the JAX converter casts. Tensors
are read one at a time and moved to `device` before they are stacked.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import torch

from vitron_tpu_torch.models.llm.loader import as_tensor
from vitron_tpu_torch.models.vision.vit import ViTConfig


def convert_hf_clip_vision(state_dict: Mapping[str, Any], cfg: ViTConfig,
                           device="cpu") -> Dict[str, Any]:
    device = torch.device(device)
    dt = cfg.param_dtype
    p = cfg.patch_size

    def get(name: str) -> torch.Tensor:
        return as_tensor(state_dict["vision_model." + name]).to(device).to(torch.float32).to(dt)

    def stack_t(fmt):  # stacked, transposed projections
        return torch.stack([get(fmt.format(i)).t() for i in range(cfg.num_layers)])

    def stack(fmt):
        return torch.stack([get(fmt.format(i)) for i in range(cfg.num_layers)])

    def attn(stem):
        return {
            "wq": stack_t(stem + ".q_proj.weight"), "bq": stack(stem + ".q_proj.bias"),
            "wk": stack_t(stem + ".k_proj.weight"), "bk": stack(stem + ".k_proj.bias"),
            "wv": stack_t(stem + ".v_proj.weight"), "bv": stack(stem + ".v_proj.bias"),
            "wo": stack_t(stem + ".out_proj.weight"), "bo": stack(stem + ".out_proj.bias"),
        }

    def ln(stem):
        return {"scale": stack(stem + ".weight"), "bias": stack(stem + ".bias")}

    # conv [H, 3, P, P] -> the unfold matmul's weight [(ph pw c), H]
    patch_proj = get("embeddings.patch_embedding.weight").permute(2, 3, 1, 0).reshape(
        p * p * 3, cfg.hidden_size).contiguous()
    layers: Dict[str, Any] = {
        "ln1": ln("encoder.layers.{}.layer_norm1"),
        "attn": attn("encoder.layers.{}.self_attn"),
        "ln2": ln("encoder.layers.{}.layer_norm2"),
        "fc1": stack_t("encoder.layers.{}.mlp.fc1.weight"),
        "b1": stack("encoder.layers.{}.mlp.fc1.bias"),
        "fc2": stack_t("encoder.layers.{}.mlp.fc2.weight"),
        "b2": stack("encoder.layers.{}.mlp.fc2.bias"),
    }
    if cfg.add_time_attn:
        layers["t_emb"] = stack("encoder.layers.{}.temporal_embedding")[:, 0]
        layers["t_ln"] = ln("encoder.layers.{}.temporal_layer_norm1")
        layers["t_attn"] = attn("encoder.layers.{}.temporal_attn")
    return {
        "class_emb": get("embeddings.class_embedding"),
        "patch_proj": patch_proj,
        "pos_emb": get("embeddings.position_embedding.weight"),
        # LanguageBind names it pre_layrnorm (sic), as HF CLIP does
        "pre_ln": {"scale": get("pre_layrnorm.weight"), "bias": get("pre_layrnorm.bias")},
        "layers": layers,
        "post_ln": {"scale": get("post_layernorm.weight"), "bias": get("post_layernorm.bias")},
    }
