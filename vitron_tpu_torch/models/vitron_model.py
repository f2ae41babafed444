"""Vitron multimodal meta-architecture in PyTorch.

Port of `vitron_tpu/models/vitron_model.py`: CLIP/LanguageBind towers ->
mm projector (+ region extractor on the raw tower features) -> sentinel
splice -> Llama decoder. The host planner (`plan_splice`) emits fixed-shape
gather maps; everything here runs on the parameters' device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from vitron_tpu_torch.mm.splice import apply_splice
from vitron_tpu_torch.models.llm import llama
from vitron_tpu_torch.models.vision import projector as projector_mod
from vitron_tpu_torch.models.vision import region_extractor as region_mod
from vitron_tpu_torch.models.vision import vit


@dataclasses.dataclass(frozen=True)
class VitronConfig:
    llm: llama.LlamaConfig = dataclasses.field(default_factory=llama.LlamaConfig)
    image_tower: vit.ViTConfig = dataclasses.field(default_factory=vit.ViTConfig.clip_vit_l14)
    video_tower: vit.ViTConfig = dataclasses.field(default_factory=vit.ViTConfig.video_vit_l14)
    projector_type: str = "mlp2x_gelu"

    @property
    def vision_hidden(self) -> int:
        return self.image_tower.hidden_size

    @staticmethod
    def tiny(**kw) -> "VitronConfig":
        base = dict(
            llm=llama.LlamaConfig.tiny(),
            image_tower=vit.ViTConfig.tiny(),
            video_tower=vit.ViTConfig.tiny(add_time_attn=True),
        )
        base.update(kw)
        return VitronConfig(**base)

    @staticmethod
    def serving(**kw) -> "VitronConfig":
        """Inference config: bfloat16 tower weights and compute."""
        base = dict(
            image_tower=vit.ViTConfig.clip_vit_l14(
                param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16),
            video_tower=vit.ViTConfig.video_vit_l14(
                param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16),
        )
        base.update(kw)
        return VitronConfig(**base)


def init_params(gen: torch.Generator, cfg: VitronConfig, device) -> Dict[str, Any]:
    """Random weights at the config's full width, made on `device` from
    `gen` (a generator on that device). The projector and region extractor
    take the image tower's dtype."""
    vdt = cfg.image_tower.param_dtype
    return {
        "llm": llama.init_params(gen, cfg.llm, device),
        "image_tower": vit.init_params(gen, cfg.image_tower, device),
        "video_tower": vit.init_params(gen, cfg.video_tower, device),
        "projector": projector_mod.init_params(
            gen, cfg.vision_hidden, cfg.llm.hidden_size, device, cfg.projector_type, vdt),
        "region": region_mod.init_params(
            gen, cfg.vision_hidden, cfg.llm.hidden_size, device, vdt),
    }


def encode_media(params: Dict[str, Any], cfg: VitronConfig,
                 images: Optional[torch.Tensor], videos: Optional[torch.Tensor],
                 block_perm: Optional[torch.Tensor] = None,
                 region_boxes: Optional[torch.Tensor] = None,
                 region_block_idx: Optional[torch.Tensor] = None
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Encode all media into flat image-sized feature blocks ->
    (image_feats [n_blocks, P, H_llm], region_feats [n_blocks, 1, H_llm] or
    None). Images give one block, videos `T` consecutive blocks; block_perm
    maps the [images.., video frames..] concat order to planner order.
    Region features pool the RAW tower features, not the projected ones."""
    raw_blocks = []
    if images is not None and images.shape[0] > 0:
        raw_blocks.append(vit.forward_features(params["image_tower"], cfg.image_tower, images))
    if videos is not None and videos.shape[0] > 0:
        vfeats = vit.forward_video_features(params["video_tower"], cfg.video_tower, videos)
        nv, t, p, h = vfeats.shape
        raw_blocks.append(vfeats.reshape(nv * t, p, h))
    if not raw_blocks:
        return None, None
    raw = torch.cat(raw_blocks, dim=0) if len(raw_blocks) > 1 else raw_blocks[0]
    if block_perm is not None:
        raw = raw[block_perm]
    feats = projector_mod.apply(params["projector"], raw)

    region_feats = None
    if region_boxes is not None and region_boxes.shape[0] > 0:
        src = raw[region_block_idx]  # [Nr, P, H_vis]
        r = region_mod.apply(params["region"], src, region_boxes,
                             image_size=cfg.image_tower.image_size)  # [Nr, 1, H_llm]
        region_feats = torch.zeros((feats.shape[0], 1, feats.shape[-1]), dtype=feats.dtype,
                                   device=feats.device)
        region_feats[region_block_idx] = r.to(feats.dtype)
    return feats, region_feats


def spliced_embeds(params: Dict[str, Any], cfg: VitronConfig, plan_token_ids: torch.Tensor,
                   plan_media_idx: torch.Tensor, plan_use_media: torch.Tensor,
                   images=None, videos=None, block_perm=None, region_boxes=None,
                   region_block_idx=None) -> torch.Tensor:
    """Encode media and splice into the text embeddings -> [B, L, H_llm]."""
    image_feats, region_feats = encode_media(
        params, cfg, images, videos, block_perm, region_boxes, region_block_idx)
    embed_table = params["llm"]["embed"]
    if image_feats is None:
        return embed_table[plan_token_ids]
    return apply_splice(embed_table, plan_token_ids, plan_media_idx, plan_use_media,
                        image_feats, region_feats)


def forward(params: Dict[str, Any], cfg: VitronConfig, plan_token_ids, plan_media_idx,
            plan_use_media, positions, attn_mask, images=None, videos=None,
            block_perm=None, region_boxes=None, region_block_idx=None,
            cache: Optional[llama.KVCache] = None):
    """Multimodal prefill: encode media, splice, run the decoder ->
    (logits, cache)."""
    embeds = spliced_embeds(
        params, cfg, plan_token_ids, plan_media_idx, plan_use_media,
        images=images, videos=videos, block_perm=block_perm,
        region_boxes=region_boxes, region_block_idx=region_block_idx)
    return llama.forward(params["llm"], cfg.llm, embeds, positions,
                         attn_mask=attn_mask, cache=cache)


def decode_step(params: Dict[str, Any], cfg: VitronConfig, token_ids: torch.Tensor,
                positions: torch.Tensor, cache: llama.KVCache):
    """Single-token decode [B, 1]; the splice is bypassed."""
    return llama.forward_tokens(
        params["llm"], cfg.llm, token_ids, positions=positions,
        attn_mask=torch.ones_like(token_ids, dtype=torch.bool), cache=cache)
