"""SEEM segmentation model: backbone -> pixel decoder -> SEEM decoder.

Port of `vitron_tpu/models/seem/model.py` (:35-263), the reference SEEM_Model
and its demo task drivers (modules/SEEM/demo_code/xdecoder/architectures/
seem_model.py:34-927, tasks/interactive.py:36-316):

- text-grounded segmentation: phrase -> grounding tokens -> decoder, the
  query whose caption embedding best matches the phrase (vl_similarity);
- audio-referred: a transcript through the decoder's audio token group;
- stroke: sampled spatial tokens, the query closest to their pooled embedding;
- visual / example segmentation and video tracking (reference frame ->
  visual queries -> one encode and decode per frame);
- 'segment everything' against a class bank (panoptic).

Inputs are 512x512 uint8 images. With `compute_dtype="bfloat16"` the
backbone and pixel decoder run in bf16 and their outputs are cast back to
float32 at `encode_image`'s boundary; the decoder and language encoder stay
float32, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from vitron_tpu_torch.media.preprocess import _resize_hw
from vitron_tpu_torch.models.seem import decoder as dec
from vitron_tpu_torch.models.seem import focalnet, language, pixel_decoder

PIXEL_MEAN = (123.675, 116.280, 103.530)
PIXEL_STD = (58.395, 57.120, 57.375)


@dataclasses.dataclass(frozen=True)
class SeemConfig:
    backbone: focalnet.FocalNetConfig = dataclasses.field(
        default_factory=focalnet.FocalNetConfig.focall)
    pixel: pixel_decoder.PixelDecoderConfig = dataclasses.field(
        default_factory=pixel_decoder.PixelDecoderConfig)
    decoder: dec.SeemDecoderConfig = dataclasses.field(default_factory=dec.SeemDecoderConfig)
    lang: language.LangConfig = dataclasses.field(default_factory=language.LangConfig)
    input_size: int = 512
    # "bfloat16" runs the backbone + pixel decoder in bf16 (serving)
    compute_dtype: str = "float32"

    @staticmethod
    def tiny(**kw) -> "SeemConfig":
        base = dict(backbone=focalnet.FocalNetConfig.tiny(),
                    pixel=pixel_decoder.PixelDecoderConfig.tiny(),
                    decoder=dec.SeemDecoderConfig.tiny(),
                    lang=language.LangConfig.tiny(), input_size=64)
        base.update(kw)
        return SeemConfig(**base)


def init_params(gen: torch.Generator, cfg: SeemConfig, device) -> Dict[str, Any]:
    return {"backbone": focalnet.init_params(gen, cfg.backbone, device),
            "pixel": pixel_decoder.init_params(gen, cfg.pixel, device),
            "decoder": dec.init_params(gen, cfg.decoder, device),
            "lang": language.init_params(gen, cfg.lang, device)}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast(v, dtype) for v in tree)
    return tree.to(dtype) if tree.dtype == torch.float32 else tree


def cast_tower_params(params: Dict[str, Any], dtype=torch.bfloat16) -> Dict[str, Any]:
    """The backbone + pixel-decoder float32 weights cast for bf16 serving;
    decoder and language params stay float32."""
    return {**params, "backbone": _cast(params["backbone"], dtype),
            "pixel": _cast(params["pixel"], dtype)}


def normalize_pixels(image: torch.Tensor) -> torch.Tensor:
    """uint8 [H, W, 3] RGB -> normalized float32 (seem_model.py:260-261)."""
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=image.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=image.device)
    return (image.to(torch.float32) - mean) / std


def encode_image(params, cfg: SeemConfig, image: torch.Tensor):
    """image: [H, W, 3] uint8 -> (mask_features, multi_scale, srcs_2d)."""
    x = normalize_pixels(image)[None].to(getattr(torch, cfg.compute_dtype))
    feats = focalnet.forward(params["backbone"], cfg.backbone, x)
    mask_features, multi_scale = pixel_decoder.forward_features(params["pixel"], cfg.pixel, feats)
    if cfg.compute_dtype != "float32":
        mask_features = mask_features.to(torch.float32)
        multi_scale = [m.to(torch.float32) for m in multi_scale]
    # per-level 2D views for spatial-token point sampling (seem.py:440-443)
    return mask_features, multi_scale, [m[0] for m in multi_scale]


def _normalize(x):
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-7)


def _pick(out, matched):
    mask = out["pred_masks"][0, matched]
    logits = out["pred_logits"][0, matched] if out["pred_logits"] is not None else None
    return mask, logits


def _segment_by_text(params, cfg, image, ids, tok_mask, group: str, class_embeddings):
    mask_features, multi_scale, _ = encode_image(params, cfg, image)
    token_emb, class_emb = language.token_and_class_emb(params["lang"], cfg.lang, ids)
    out = dec.forward(params["decoder"], cfg.decoder, multi_scale, mask_features,
                      class_embeddings=class_embeddings,
                      logit_scale=params["lang"]["logit_scale"],
                      **{f"{group}_tokens": token_emb[0],
                         f"{group}_valid": tok_mask[0].to(torch.bool)})
    sim = language.vl_similarity(_normalize(out["pred_captions"][0]), _normalize(class_emb),
                                 params["lang"]["logit_scale"])  # [1, Q]
    return _pick(out, torch.argmax(sim[0]))


def segment_text(params, cfg: SeemConfig, image: torch.Tensor, phrase_ids: torch.Tensor,
                 phrase_mask: torch.Tensor, class_embeddings: Optional[torch.Tensor] = None):
    """Text-grounded segmentation (interactive.py:162-176). phrase_ids/mask:
    [1, 77] tokens of the referring phrase. Returns (mask [H/4, W/4] logits,
    class logits or None)."""
    return _segment_by_text(params, cfg, image, phrase_ids, phrase_mask, "grounding",
                            class_embeddings)


def segment_audio(params, cfg: SeemConfig, image: torch.Tensor, transcript_ids: torch.Tensor,
                  transcript_mask: torch.Tensor,
                  class_embeddings: Optional[torch.Tensor] = None):
    """Audio-referred segmentation (interactive.py:105-109, 177-191): the
    host-side transcript's tokens enter the decoder's audio token group
    (seem_model.py:291-299) and are matched like the text path."""
    return _segment_by_text(params, cfg, image, transcript_ids, transcript_mask, "audio",
                            class_embeddings)


def segment_stroke(params, cfg: SeemConfig, image: torch.Tensor, points: torch.Tensor,
                   points_valid: torch.Tensor, class_embeddings=None):
    """Stroke segmentation (interactive.py:138-149). points: [S, 2]
    normalized (y, x) from `decoder.sample_stroke_points`."""
    mask_features, multi_scale, srcs_2d = encode_image(params, cfg, image)
    sp_tokens, sp_pos = dec.build_spatial_tokens(params["decoder"], cfg.decoder, srcs_2d,
                                                 mask_features, points, points_valid)
    out = dec.forward(params["decoder"], cfg.decoder, multi_scale, mask_features,
                      class_embeddings=class_embeddings,
                      logit_scale=params["lang"]["logit_scale"],
                      spatial_queries=sp_tokens, spatial_valid=points_valid,
                      spatial_pos_embed=sp_pos[None])
    matched = torch.argmax(out["pred_maskembs"][0] @ out["pred_pspatials"][0][0])
    return _pick(out, matched)


def reference_visual_queries(params, cfg: SeemConfig, image: torch.Tensor,
                             points: torch.Tensor, points_valid: torch.Tensor):
    """'refimg' (seem.py:464-471): the reference image's spatial tokens and
    pooled embedding, kept as visual queries for other frames."""
    mask_features, _, srcs_2d = encode_image(params, cfg, image)
    vq, v_pos = dec.build_spatial_tokens(params["decoder"], cfg.decoder, srcs_2d,
                                         mask_features, points, points_valid)
    return vq, v_pos[None], points_valid


def segment_visual(params, cfg: SeemConfig, image: torch.Tensor, visual_queries, visual_pos,
                   visual_valid, class_embeddings=None):
    """Example segmentation of a frame against reference visual queries
    (interactive.py:151-160, video loop :219-316)."""
    mask_features, multi_scale, _ = encode_image(params, cfg, image)
    out = dec.forward(params["decoder"], cfg.decoder, multi_scale, mask_features,
                      class_embeddings=class_embeddings,
                      logit_scale=params["lang"]["logit_scale"],
                      visual_queries=visual_queries, visual_valid=visual_valid,
                      visual_pos_embed=visual_pos)
    matched = torch.argmax(out["pred_maskembs"][0] @ out["pred_pvisuals"][0][0])
    return _pick(out, matched)


def segment_panoptic(params, cfg: SeemConfig, image: torch.Tensor, class_bank: torch.Tensor):
    """'Segment everything' (seem_model.py:819-875): every query scored
    against the class bank [K+1, dim_proj] (last row 'background'). Returns
    (class_logits [Q, K+1], mask_logits [Q, h, w])."""
    mask_features, multi_scale, _ = encode_image(params, cfg, image)
    out = dec.forward(params["decoder"], cfg.decoder, multi_scale, mask_features,
                      class_embeddings=class_bank, logit_scale=params["lang"]["logit_scale"])
    return out["pred_logits"][0], out["pred_masks"][0]


def upsample_mask(mask_logits: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample + 0 threshold (interactive.py:195-197)."""
    m = _resize_hw(mask_logits[..., None], out_hw[0], out_hw[1], "linear")[..., 0]
    return m > 0.0


def track_video(params, cfg: SeemConfig, frames: torch.Tensor, ref_image: torch.Tensor,
                points: torch.Tensor, points_valid: torch.Tensor) -> torch.Tensor:
    """Video object tracking (interactive_infer_video, interactive.py:219-316):
    the reference stroke -> visual queries, then one visual segmentation per
    frame (T + 1 `encode_image` calls). frames: [T, H, W, 3] uint8 ->
    [T, H/4, W/4] bool."""
    vq, v_pos, v_valid = reference_visual_queries(params, cfg, ref_image, points, points_valid)
    masks = [segment_visual(params, cfg, frame, vq, v_pos, v_valid)[0] for frame in frames]
    return torch.stack(masks) > 0.0
