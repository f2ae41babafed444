"""Sketch-pad state: stroke masks <-> boxes for the interactive UI.

Rebuilds the reference UI-state helpers (reference: app_utils.py:7-143
ImageBoxState / bbox_draw / mask_to_bbox): accumulate stroke masks, derive
tight bounding boxes, and reset between turns. Framework-agnostic (numpy
in / numpy out) so any frontend can drive it. The port's own copy of
`vitron_tpu/mm/sketch.py`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def mask_to_bbox(mask: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """Tight (x1, y1, x2, y2) around nonzero pixels (app_utils.py:134-143);
    None for an empty mask."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return None
    return int(xs.min()), int(ys.min()), int(xs.max()) + 1, int(ys.max()) + 1


def bbox_to_mask(box: Sequence[float], hw: Tuple[int, int]) -> np.ndarray:
    m = np.zeros(hw, bool)
    x1, y1, x2, y2 = (int(v) for v in box)
    m[max(y1, 0):max(y2, 0), max(x1, 0):max(x2, 0)] = True
    return m


class ImageBoxState:
    """Stroke/box accumulation across a chat turn (app_utils.py:7-104)."""

    def __init__(self, image_hw: Optional[Tuple[int, int]] = None):
        self.image_hw = image_hw
        self.masks: List[np.ndarray] = []
        self.boxes: List[Tuple[int, int, int, int]] = []

    def add_stroke(self, mask: np.ndarray) -> None:
        if self.image_hw is None:
            self.image_hw = mask.shape[:2]
        self.masks.append(mask.astype(bool))
        box = mask_to_bbox(mask)
        if box is not None:
            self.boxes.append(box)

    def add_box(self, box: Sequence[float]) -> None:
        if self.image_hw is not None:
            self.masks.append(bbox_to_mask(box, self.image_hw))
        self.boxes.append(tuple(int(v) for v in box))

    def merged_mask(self) -> Optional[np.ndarray]:
        if not self.masks:
            return None
        out = self.masks[0].copy()
        for m in self.masks[1:]:
            out |= m
        return out

    def reset(self) -> None:
        self.masks.clear()
        self.boxes.clear()


def order_pick_k(items: Sequence, k: int, rng: Optional[np.random.RandomState] = None):
    """Randomly subsample to k while PRESERVING original order
    (reference vitron/utils.py order_pick_k — used to clamp media lists)."""
    if len(items) <= k:
        return list(items)
    rng = rng or np.random.RandomState(0)
    idx = np.sort(rng.choice(len(items), k, replace=False))
    return [items[i] for i in idx]
