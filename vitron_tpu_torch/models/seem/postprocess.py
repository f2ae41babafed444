"""SEEM inference postprocessing: semantic / panoptic / instance.

Port of `vitron_tpu/models/seem/postprocess.py`, the Mask2Former-style heads
of the reference (modules/SEEM/demo_code/xdecoder/architectures/
seem_model.py:813-927). `semantic_inference` is tensor math; the segment
bookkeeping is host-side numpy, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch


def semantic_inference(mask_cls: torch.Tensor, mask_pred: torch.Tensor) -> torch.Tensor:
    """[Q, K+1] logits x [Q, H, W] mask logits -> [K, H, W] class scores
    (seem_model.py:813-817; the last class column is 'no object')."""
    cls = torch.softmax(mask_cls, dim=-1)[..., :-1]
    return torch.einsum("qc,qhw->chw", cls, torch.sigmoid(mask_pred))


@dataclasses.dataclass
class PanopticSegment:
    id: int
    isthing: bool
    category_id: int


def panoptic_inference(
    mask_cls: np.ndarray,          # [Q, K+1]
    mask_pred: np.ndarray,         # [Q, H, W] logits
    thing_ids: Set[int],
    object_mask_threshold: float = 0.8,
    overlap_threshold: float = 0.8,
) -> Tuple[np.ndarray, List[PanopticSegment]]:
    """Greedy panoptic map (seem_model.py:819-875): keep confident non-void
    queries, argmax of score-weighted masks, drop heavily-occluded segments,
    merge stuff regions per class."""
    num_classes = mask_cls.shape[-1] - 1
    probs = _softmax_np(mask_cls)
    scores = probs.max(-1)
    labels = probs.argmax(-1)
    masks = _sigmoid_np(mask_pred)

    keep = (labels != num_classes) & (scores > object_mask_threshold)
    cur_scores = scores[keep]
    cur_classes = labels[keep]
    cur_masks = masks[keep]

    h, w = mask_pred.shape[-2:]
    panoptic = np.zeros((h, w), np.int32)
    segments: List[PanopticSegment] = []
    if cur_masks.shape[0] == 0:
        return panoptic, segments

    cur_prob_masks = cur_scores[:, None, None] * cur_masks
    mask_ids = cur_prob_masks.argmax(0)
    stuff_memory: Dict[int, int] = {}
    seg_id = 0
    for k in range(cur_classes.shape[0]):
        pred_class = int(cur_classes[k])
        isthing = pred_class in thing_ids
        mask = (mask_ids == k) & (cur_masks[k] >= 0.5)
        mask_area = int(mask.sum())
        original_area = int((cur_masks[k] >= 0.5).sum())
        if mask_area == 0 or original_area == 0:
            continue
        if mask_area / original_area < overlap_threshold:
            continue
        if not isthing:
            if pred_class in stuff_memory:
                panoptic[mask] = stuff_memory[pred_class]
                continue
            stuff_memory[pred_class] = seg_id + 1
        seg_id += 1
        panoptic[mask] = seg_id
        segments.append(PanopticSegment(id=seg_id, isthing=isthing,
                                        category_id=pred_class))
    return panoptic, segments


def instance_inference(
    mask_cls: np.ndarray, mask_pred: np.ndarray,
    topk: int = 100, thing_ids: Optional[Set[int]] = None,
) -> Dict[str, np.ndarray]:
    """Top-k instances over (query, class) pairs (seem_model.py:877-927);
    score = class prob * mask-confidence."""
    num_classes = mask_cls.shape[-1] - 1
    num_queries = mask_cls.shape[0]
    scores = _softmax_np(mask_cls)[:, :-1]
    flat = scores.reshape(-1)
    topk = min(topk, flat.size)
    idx = np.argpartition(-flat, topk - 1)[:topk]
    labels = idx % num_classes
    query_idx = idx // num_classes
    sel_scores = flat[idx]
    sel_masks = mask_pred[query_idx]
    if thing_ids is not None:
        keep = np.asarray([int(l) in thing_ids for l in labels])
        sel_scores, labels, sel_masks = sel_scores[keep], labels[keep], sel_masks[keep]
    bin_masks = sel_masks > 0
    msig = _sigmoid_np(sel_masks)
    conf = (msig * bin_masks).reshape(len(msig), -1).sum(1) / (
        bin_masks.reshape(len(bin_masks), -1).sum(1) + 1e-6)
    return {"scores": sel_scores * conf, "labels": labels,
            "masks": bin_masks}


def _softmax_np(x):
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


def _sigmoid_np(x):
    return 1.0 / (1.0 + np.exp(-x))


# COCO-133 panoptic categories (reference pre-embeds these class texts at
# startup, demo_code/app.py:69-71; names from the COCO panoptic split).
COCO_PANOPTIC_CLASSES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush", "banner", "blanket", "bridge", "cardboard",
    "counter", "curtain", "door-stuff", "floor-wood", "flower", "fruit",
    "gravel", "house", "light", "mirror-stuff", "net", "pillow", "platform",
    "playingfield", "railroad", "river", "road", "roof", "sand", "sea",
    "shelf", "snow", "stairs", "tent", "towel", "wall-brick", "wall-stone",
    "wall-tile", "wall-wood", "water-other", "window-blind", "window-other",
    "tree-merged", "fence-merged", "ceiling-merged", "sky-other-merged",
    "cabinet-merged", "table-merged", "floor-other-merged", "pavement-merged",
    "mountain-merged", "grass-merged", "dirt-merged", "paper-merged",
    "food-other-merged", "building-other-merged", "rock-merged",
    "wall-other-merged", "rug-merged",
]
COCO_THING_IDS = set(range(80))  # first 80 are things
