"""Device half of the static-shape multimodal splice.

The host planner `plan_splice` (and `SplicePlan`) is pure numpy and is
imported from `vitron_tpu.mm.splice`; this module ports only
`apply_splice`: two gathers and a select.
"""
from __future__ import annotations

from typing import Optional

import torch


def apply_splice(embedding_table: torch.Tensor, plan_token_ids: torch.Tensor,
                 plan_media_idx: torch.Tensor, plan_use_media: torch.Tensor,
                 image_feats: torch.Tensor,
                 region_feats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, L] plan maps + [n_blocks, image_len, H] media features (+ optional
    [n_blocks, region_len, H] region rows) -> [B, L, H] input embeddings."""
    h = embedding_table.shape[-1]
    text_emb = embedding_table[plan_token_ids]
    flat = image_feats.reshape(-1, h)
    if region_feats is not None:
        flat = torch.cat([flat, region_feats.reshape(-1, h)], dim=0)
    media_emb = flat[plan_media_idx]
    return torch.where(plan_use_media[..., None], media_emb.to(text_emb.dtype), text_emb)
