"""SEEM multi-scale masked-attention transformer decoder.

Port of `vitron_tpu/models/seem/decoder.py` (:36-353), the reference
MultiScaleMaskedTransformerDecoder (modules/SEEM/demo_code/xdecoder/body/
decoder/seem.py:218-590; 101 queries, 9 post-norm layers cycling over 3
feature scales):

- masked cross-attention: a key is blocked where the previous layer's mask
  prediction, resized to the level without antialiasing, has sigmoid < 0.5;
  fully blocked query rows are unblocked;
- self-attention over [queries | token groups] with the ATTENTION_ARCH
  interaction matrix (`_self_attn_mask`): object queries attend everything,
  grounding tokens attend objects and grounding, spatial and visual tokens
  only themselves, audio tokens objects and audio; padded slots masked;
- prediction heads: decoder norm -> class projection, 3-layer mask MLP ->
  einsum with the mask features.

Token groups are fixed-size padded tensors with validity masks, as in the
JAX package. `recording_attn_masks()` collects each layer's cross-attention
mask, so a comparison can count the bits that flip between two runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vitron_tpu_torch.media.preprocess import _resize_hw
from vitron_tpu_torch.models.seem.pixel_decoder import _ln, position_embedding_sine


@dataclasses.dataclass(frozen=True)
class SeemDecoderConfig:
    hidden_dim: int = 512
    dim_proj: int = 512
    num_queries: int = 101
    num_heads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9        # DEC_LAYERS - 1 (yaml:99)
    mask_dim: int = 512
    num_feature_levels: int = 3
    max_spatial_len: int = 512

    @staticmethod
    def tiny(**kw) -> "SeemDecoderConfig":
        base = dict(hidden_dim=32, dim_proj=32, num_queries=7, num_heads=4,
                    dim_feedforward=64, dec_layers=3, mask_dim=32,
                    num_feature_levels=2, max_spatial_len=16)
        base.update(kw)
        return SeemDecoderConfig(**base)


_ATTN_MASK_LOG: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def recording_attn_masks():
    """Yields a list that receives every cross-attention mask ([1, Q, h*w]
    bool, True = blocked) the decoder builds inside the block, in order."""
    global _ATTN_MASK_LOG
    saved, _ATTN_MASK_LOG = _ATTN_MASK_LOG, []
    try:
        yield _ATTN_MASK_LOG
    finally:
        _ATTN_MASK_LOG = saved


def init_params(gen: torch.Generator, cfg: SeemDecoderConfig, device) -> Dict[str, Any]:
    """Random-init param tree with the JAX package's shapes and scales."""
    d = cfg.hidden_dim

    def dense(cin, cout):
        return torch.randn((cin, cout), generator=gen, device=device) * cin ** -0.5

    def zeros(n):
        return torch.zeros((n,), device=device)

    def lnp():
        return {"scale": torch.ones((d,), device=device), "bias": zeros(d)}

    def attn():
        return {"in_w": dense(d, 3 * d), "in_b": zeros(3 * d),
                "out_w": dense(d, d), "out_b": zeros(d)}

    def layer():
        ff = cfg.dim_feedforward
        return {"cross": {"attn": attn(), "norm": lnp()},
                "self": {"attn": attn(), "norm": lnp()},
                "ffn": {"fc1_w": dense(d, ff), "fc1_b": zeros(ff),
                        "fc2_w": dense(ff, d), "fc2_b": zeros(d), "norm": lnp()}}

    return {
        "query_feat": dense(cfg.num_queries, d) * 0.02,
        "query_embed": dense(cfg.num_queries, d) * 0.02,
        "pn_indicator": dense(2, d) * 0.02,
        "level_embed": dense(cfg.num_feature_levels, d) * 0.02,
        "layers": [layer() for _ in range(cfg.dec_layers)],
        "decoder_norm": lnp(),
        "class_embed": dense(d, cfg.dim_proj) * 0.02,
        "mask_embed": {"w0": dense(d, d), "b0": zeros(d), "w1": dense(d, d), "b1": zeros(d),
                       "w2": dense(d, cfg.mask_dim), "b2": zeros(cfg.mask_dim)},
        "mask_spatial_embed": [dense(d, d) * 0.02 for _ in range(cfg.num_feature_levels)],
    }


def point_sample(feat: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (align_corners=True), detectron2's point_sample.
    feat: [H, W, C]; points: [K, 2] normalized (y, x) in [0, 1] -> [K, C]."""
    h, w, _ = feat.shape
    py = points[:, 0] * (h - 1)
    px = points[:, 1] * (w - 1)
    y0 = torch.clamp(torch.floor(py), 0, h - 1).long()
    x0 = torch.clamp(torch.floor(px), 0, w - 1).long()
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = py - y0
    wx = px - x0
    return (feat[y0, x0] * ((1 - wy) * (1 - wx))[:, None]
            + feat[y0, x1] * ((1 - wy) * wx)[:, None]
            + feat[y1, x0] * (wy * (1 - wx))[:, None]
            + feat[y1, x1] * (wy * wx)[:, None])


_ALLOWED = {
    "object": ["object", "grounding", "spatial", "visual", "audio"],
    "grounding": ["object", "grounding"],
    "spatial": ["spatial"],
    "visual": ["visual"],
    "audio": ["object", "audio"],
}


def _self_attn_mask(nq, groups: List[Tuple[str, int, Optional[torch.Tensor]]], device):
    """The [total, total] blocked mask (True = blocked) of the ATTENTION_ARCH
    interaction matrix. groups: (name, size, valid [size] or None)."""
    sizes = [nq] + [g[1] for g in groups]
    names = ["object"] + [g[0] for g in groups]
    offs = np.cumsum([0] + sizes)
    blocked = torch.ones((offs[-1], offs[-1]), dtype=torch.bool, device=device)
    valids = {g[0]: g[2] for g in groups}
    for i, ni in enumerate(names):
        for j, nj in enumerate(names):
            if nj in _ALLOWED.get(ni, []):
                block = torch.zeros((sizes[i], sizes[j]), dtype=torch.bool, device=device)
                # padding: keys of group j that are invalid stay blocked
                if nj != "object" and valids.get(nj) is not None:
                    block = block | ~valids[nj][None, :]
                if ni != "object" and valids.get(ni) is not None:
                    block = block | ~valids[ni][:, None]
                blocked[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = block
    return blocked


def _masked_mha(q, k, v, p, heads, blocked):
    """MultiheadAttention with a bool blocked mask [B or 1, Q, K] or
    [B, h, Q, K]."""
    e = q.shape[-1]
    d = e // heads
    wq, wk, wv = p["in_w"].chunk(3, dim=1)
    bq, bk, bv = p["in_b"].chunk(3, dim=0)
    qq = (q @ wq + bq).reshape(q.shape[0], q.shape[1], heads, d)
    kk = (k @ wk + bk).reshape(k.shape[0], k.shape[1], heads, d)
    vv = (v @ wv + bv).reshape(v.shape[0], v.shape[1], heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", qq, kk).to(torch.float32) / math.sqrt(d)
    if blocked.dim() == 3:
        blocked = blocked[:, None]
    logits = torch.where(blocked, torch.finfo(torch.float32).min, logits)
    probs = torch.softmax(logits, dim=-1).to(vv.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vv).reshape(q.shape[0], q.shape[1], e)
    return out @ p["out_w"] + p["out_b"]


def forward(
    params: Dict[str, Any],
    cfg: SeemDecoderConfig,
    multi_scale_features: List[torch.Tensor],   # 3 x [B, h, w, hidden] (res5, 4, 3)
    mask_features: torch.Tensor,                # [B, H/4, W/4, mask_dim]
    class_embeddings: Optional[torch.Tensor] = None,  # [n_cls, dim_proj]
    logit_scale: Optional[torch.Tensor] = None,
    grounding_tokens: Optional[torch.Tensor] = None,  # [T, hidden]
    grounding_valid: Optional[torch.Tensor] = None,   # [T] bool
    spatial_queries: Optional[List[torch.Tensor]] = None,  # per level [S, hidden]
    spatial_valid: Optional[torch.Tensor] = None,          # [S] bool
    spatial_pos_embed: Optional[torch.Tensor] = None,      # [1, hidden] pooled pos
    spatial_neg_embed: Optional[torch.Tensor] = None,
    visual_queries: Optional[List[torch.Tensor]] = None,
    visual_valid: Optional[torch.Tensor] = None,
    visual_pos_embed: Optional[torch.Tensor] = None,
    visual_neg_embed: Optional[torch.Tensor] = None,
    audio_tokens: Optional[torch.Tensor] = None,      # [T, hidden]
    audio_valid: Optional[torch.Tensor] = None,       # [T] bool
) -> Dict[str, torch.Tensor]:
    """Batch size 1 (the reference demo asserts bs == 1). Returns
    pred_logits, pred_masks, pred_captions, pred_maskembs and the pooled
    spatial / visual embeddings passed in."""
    d = cfg.hidden_dim
    nq = cfg.num_queries
    nl = cfg.num_feature_levels
    device = mask_features.device

    srcs, poss, sizes = [], [], []
    for i, f in enumerate(multi_scale_features):
        b, h, w, c = f.shape
        srcs.append(f.reshape(b, h * w, c) + params["level_embed"][i])
        poss.append(position_embedding_sine(h, w, d, device=device)[None].to(f.dtype))
        sizes.append((h, w))

    output = params["query_feat"][None].expand(1, nq, d)
    query_pos = params["query_embed"][None].expand(1, nq, d)

    # grounding and audio tokens are set once and evolve through
    # self-attention, their position embedding frozen at the original values
    # (seem.py:483-493); spatial / visual tokens re-seed from their per-level
    # sources every layer (seem.py:519-533)
    g_state = g_pos = grounding_tokens[None] if grounding_tokens is not None else None
    a_state = a_pos = audio_tokens[None] if audio_tokens is not None else None

    groups: List[Tuple[str, int, Optional[torch.Tensor], Any]] = []
    if grounding_tokens is not None:
        groups.append(("grounding", grounding_tokens.shape[0], grounding_valid, None))
    if spatial_queries is not None:
        groups.append(("spatial", spatial_queries[0].shape[0], spatial_valid,
                       lambda lvl: spatial_queries[lvl]))
    if visual_queries is not None:
        groups.append(("visual", visual_queries[0].shape[0], visual_valid,
                       lambda lvl: visual_queries[lvl]))
    if audio_tokens is not None:
        groups.append(("audio", audio_tokens.shape[0], audio_valid, None))

    blocked = _self_attn_mask(nq, [(g[0], g[1], g[2]) for g in groups], device)

    def prediction_heads(output, size):
        dec = _ln(output, params["decoder_norm"])
        class_embed = dec @ params["class_embed"]           # [1, nq, dim_proj]
        me = params["mask_embed"]
        m = torch.relu(dec @ me["w0"] + me["b0"])
        m = torch.relu(m @ me["w1"] + me["b1"])
        m = m @ me["w2"] + me["b2"]
        masks = torch.einsum("bqc,bhwc->bqhw", m, mask_features)
        # cross-attention mask of the next layer at `size`, antialias off as
        # F.interpolate(mode='bilinear') (seem.py:565)
        am = _resize_hw(masks[..., None], size[0], size[1], "linear", antialias=False)
        am = torch.sigmoid(am.reshape(1, nq, -1)) < 0.5
        # unblock fully blocked rows (attention_data_struct:185)
        am = am & ~am.all(dim=-1, keepdim=True)
        if _ATTN_MASK_LOG is not None:
            _ATTN_MASK_LOG.append(am)
        return class_embed, masks, m, am

    class_embed, masks, maskemb, attn_mask = prediction_heads(output, sizes[0])

    for li in range(cfg.dec_layers):
        lvl = li % nl
        lp = params["layers"][li]
        # masked cross attention (object queries only)
        att = _masked_mha(output + query_pos, srcs[lvl] + poss[lvl], srcs[lvl],
                          lp["cross"]["attn"], cfg.num_heads, attn_mask)
        output = _ln(output + att, lp["cross"]["norm"])

        # self attention over [queries | token groups]
        toks, tok_pos = [output], [query_pos]
        for name, _, _, get in groups:
            if name == "grounding":
                toks.append(g_state)
                tok_pos.append(g_pos)
            elif name == "audio":
                toks.append(a_state)
                tok_pos.append(a_pos)
            else:
                t = get(lvl)[None]
                toks.append(t)
                tok_pos.append(t)  # pos = the tokens as set (ref)
        cat = torch.cat(toks, dim=1)
        qk = cat + torch.cat(tok_pos, dim=1)
        att = _masked_mha(qk, qk, cat, lp["self"]["attn"], cfg.num_heads, blocked[None])
        cat = _ln(cat + att, lp["self"]["norm"])
        # the FFN applies to the whole concatenation (reference FFNLayer)
        f = lp["ffn"]
        h2 = torch.relu(cat @ f["fc1_w"] + f["fc1_b"]) @ f["fc2_w"] + f["fc2_b"]
        cat = _ln(cat + h2, f["norm"])
        output = cat[:, :nq]
        if g_state is not None:
            g_state = cat[:, nq:nq + g_state.shape[1]]
        if a_state is not None:  # audio is the last group in the concat
            a_state = cat[:, cat.shape[1] - a_state.shape[1]:]

        class_embed, masks, maskemb, attn_mask = prediction_heads(output, sizes[(li + 1) % nl])

    logits = None
    if class_embeddings is not None:
        v = class_embed / (torch.linalg.vector_norm(class_embed, dim=-1, keepdim=True) + 1e-7)
        scale = torch.exp(logit_scale) if logit_scale is not None else 1.0
        logits = scale * v @ class_embeddings.T[None]

    return {
        "pred_logits": logits,
        "pred_masks": masks,
        "pred_captions": class_embed,
        "pred_maskembs": maskemb,
        "pred_pspatials": spatial_pos_embed,
        "pred_nspatials": spatial_neg_embed,
        "pred_pvisuals": visual_pos_embed,
        "pred_nvisuals": visual_neg_embed,
    }


def sample_stroke_points(mask: np.ndarray, max_len: int, rng: np.random.RandomState):
    """Host side: nonzero (y, x) coords of a stroke mask, randomly subsampled
    to max_len, normalized, padded (seem.py:419-430). Returns
    (points [max_len, 2] float32, valid [max_len] bool)."""
    ys, xs = np.nonzero(mask)
    pts = np.stack([ys / mask.shape[0], xs / mask.shape[1]], axis=1).astype(np.float32)
    if len(pts) > max_len:
        pts = pts[rng.permutation(len(pts))[:max_len]]
    valid = np.zeros((max_len,), bool)
    valid[: len(pts)] = True
    out = np.zeros((max_len, 2), np.float32)
    out[: len(pts)] = pts
    return out, valid


def build_spatial_tokens(params, cfg: SeemDecoderConfig, srcs_2d: List[torch.Tensor],
                         mask_features: torch.Tensor, points: torch.Tensor,
                         valid: torch.Tensor, pos: bool = True):
    """Per-level spatial tokens from sampled stroke points (seem.py:436-459)
    and the pooled position embedding from the mask features.

    srcs_2d: per level [h, w, hidden]; points: [S, 2] normalized (y, x);
    valid: [S] bool. Returns (per_level_tokens [S, hidden], pooled [1, hidden])."""
    per_level = []
    ind = params["pn_indicator"][0] if pos else params["pn_indicator"][1]
    for i, f in enumerate(srcs_2d):
        toks = point_sample(f @ params["mask_spatial_embed"][i], points) + ind
        per_level.append(torch.where(valid[:, None], toks, 0.0))
    sampled = point_sample(mask_features[0], points)
    denom = torch.clamp(valid.sum(), min=1)
    pooled = torch.where(valid[:, None], sampled, 0.0).sum(dim=0, keepdim=True) / denom
    return per_level, pooled
