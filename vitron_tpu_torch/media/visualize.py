"""Visualization: labeled mask, panoptic and video overlays.

The port's own copy of the parts of `vitron_tpu/media/visualize.py` that
the task-B/E handlers draw with: a numpy + PIL rebuild of the reference's
detectron2-style Visualizer (modules/SEEM/demo_code/tasks/visualizer.py):

- ``draw_binary_mask``: tint, off-white contour, class text at the center
  of the largest connected component (visualizer.py:1049-1130);
- ``draw_panoptic``: stuff masks first with class text, then instances with
  "name score%" labels (``_create_text_labels``, visualizer.py:229-251) and
  per-category colors, the '-other'/'-merged' suffixes stripped
  (visualizer.py:482-541);
- ``masks_to_video_overlay``: one mask overlay per tracked frame.

Colors are a deterministic per-category palette (golden-angle hue walk)
instead of detectron2's ``random_color``/``_jitter``, as in the JAX package.
"""
from __future__ import annotations

import colorsys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def category_color(cat_id: int) -> np.ndarray:
    """Deterministic, well-separated RGB uint8 color for a category id
    (golden-angle hue walk; replaces detectron2 random_color+_jitter)."""
    h = (cat_id * 0.61803398875) % 1.0
    s = 0.85 if cat_id % 2 == 0 else 0.65
    v = 0.9 if cat_id % 3 else 0.7
    return (np.asarray(colorsys.hsv_to_rgb(h, s, v)) * 255).astype(np.uint8)


# 133-entry default palette (COCO panoptic), deterministic
COLORS = np.stack([category_color(i) for i in range(133)])
_OFF_WHITE = np.asarray((224, 224, 224), np.float32)


def _create_text_labels(classes, scores, class_names) -> Optional[List[str]]:
    """visualizer.py:229-251."""
    labels = None
    if classes is not None:
        if class_names is not None and len(class_names) > 0:
            labels = [class_names[i] for i in classes]
        else:
            labels = [str(i) for i in classes]
    if scores is not None:
        if labels is None:
            labels = ["{:.0f}%".format(s * 100) for s in scores]
        else:
            labels = ["{} {:.0f}%".format(l, s * 100)
                      for l, s in zip(labels, scores)]
    return labels


def _strip(name: str) -> str:
    return name.replace("-other", "").replace("-merged", "")


def _change_color_brightness(color: np.ndarray, factor: float) -> Tuple[int, int, int]:
    """detectron2 _change_color_brightness (visualizer.py:1195+): shift
    lightness in HLS space; used to pick a readable label color."""
    r, g, b = (float(c) / 255 for c in color[:3])
    h, l, s = colorsys.rgb_to_hls(r, g, b)
    l = min(1.0, max(0.0, l + factor * l))
    rgb = colorsys.hls_to_rgb(h, l, s)
    return tuple(int(c * 255) for c in rgb)


def _label_anchor(mask: np.ndarray) -> Optional[Tuple[int, int]]:
    """(x, y) center of the largest connected component — where detectron2
    places the class text (visualizer.py draw_binary_mask text placement)."""
    if not mask.any():
        return None
    try:
        from scipy import ndimage
        lab, n = ndimage.label(mask)
        if n > 1:
            sizes = ndimage.sum(mask, lab, range(1, n + 1))
            mask = lab == (1 + int(np.argmax(sizes)))
    except Exception:
        pass
    ys, xs = np.nonzero(mask)
    return int(np.median(xs)), int(np.median(ys))


def _draw_text(image: np.ndarray, text: str, xy: Tuple[int, int],
               color: Tuple[int, int, int]) -> np.ndarray:
    """Class text with a dark halo for legibility (detectron2 draws with a
    black path effect, visualizer.py:863-900)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image)
    d = ImageDraw.Draw(img)
    x, y = xy
    x = min(max(x, 2), image.shape[1] - 2)
    y = min(max(y - 5, 2), image.shape[0] - 12)
    for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        d.text((x + dx, y + dy), text, fill=(0, 0, 0), anchor="mm")
    d.text((x, y), text, fill=color, anchor="mm")
    return np.asarray(img)


def draw_binary_mask(image: np.ndarray, mask: np.ndarray,
                     color: Optional[Sequence[int]] = None,
                     alpha: float = 0.5,
                     edge_color: Optional[Sequence[int]] = None,
                     text: Optional[str] = None,
                     area_threshold: Optional[int] = None) -> np.ndarray:
    """Tint `mask` pixels, draw its contour, optionally label it.
    image uint8 [H, W, 3] (visualizer.py:1049-1130)."""
    m = mask.astype(bool)
    if area_threshold is not None and m.sum() < area_threshold:
        return image
    out = image.astype(np.float32).copy()
    color = np.asarray(color if color is not None else COLORS[0], np.float32)
    out[m] = out[m] * (1 - alpha) + color * alpha
    edge = _mask_edges(m)
    out[edge] = _OFF_WHITE if edge_color is None else np.asarray(edge_color, np.float32)
    out8 = out.astype(np.uint8)
    if text:
        anchor = _label_anchor(m)
        if anchor is not None:
            out8 = _draw_text(out8, text, anchor,
                              _change_color_brightness(color, 0.7))
    return out8


def _mask_edges(m: np.ndarray) -> np.ndarray:
    e = np.zeros_like(m)
    e[:-1] |= m[:-1] != m[1:]
    e[:, :-1] |= m[:, :-1] != m[:, 1:]
    return e & _dilate(m)


def _dilate(m: np.ndarray) -> np.ndarray:
    out = m.copy()
    out[1:] |= m[:-1]
    out[:-1] |= m[1:]
    out[:, 1:] |= m[:, :-1]
    out[:, :-1] |= m[:, 1:]
    return out


def draw_panoptic(image: np.ndarray, panoptic: np.ndarray,
                  segments, class_names: Optional[Sequence[str]] = None,
                  alpha: float = 0.7,
                  thing_ids: Optional[set] = None,
                  area_threshold: Optional[int] = None,
                  ) -> Tuple[np.ndarray, Dict[int, str]]:
    """Labeled panoptic overlay; returns (overlay, {segment_id: label}).

    segments: objects/dicts with .id/.category_id (+ optional .score,
    .isthing). Stuff segments draw first with class text; thing instances
    then draw with "name score%" labels (visualizer.py:482-541)."""
    def field(s, k, default=None):
        if isinstance(s, dict):
            return s.get(k, default)
        return getattr(s, k, default)

    labels_out: Dict[int, str] = {}
    stuff, things = [], []
    for seg in segments:
        cat = int(field(seg, "category_id"))
        isthing = field(seg, "isthing")
        if isthing is None:
            isthing = cat in thing_ids if thing_ids is not None else False
        (things if isthing else stuff).append(seg)

    out = image
    for seg in stuff:
        cat = int(field(seg, "category_id"))
        name = _strip(class_names[cat]) if class_names and cat < len(class_names) else str(cat)
        out = draw_binary_mask(out, panoptic == field(seg, "id"),
                               color=COLORS[cat % len(COLORS)],
                               edge_color=_OFF_WHITE, text=name, alpha=alpha,
                               area_threshold=area_threshold)
        labels_out[int(field(seg, "id"))] = name

    cats = [int(field(s, "category_id")) for s in things]
    scores = [field(s, "score") for s in things]
    scores = None if any(s is None for s in scores) else scores
    names = ([_strip(class_names[c]) if c < len(class_names) else str(c)
              for c in cats] if class_names else None)
    # `names` is positional (aligned with cats), so index it by position;
    # with class_names=None label by the REAL category id, not the
    # segment's position in the things list
    texts = _create_text_labels(
        list(range(len(cats))) if names else cats, scores, names) or []
    for seg, cat, text in zip(things, cats, texts or [None] * len(things)):
        out = draw_binary_mask(out, panoptic == field(seg, "id"),
                               color=COLORS[cat % len(COLORS)],
                               edge_color=_OFF_WHITE, text=text, alpha=alpha)
        labels_out[int(field(seg, "id"))] = text or str(cat)
    return out, labels_out


def masks_to_video_overlay(frames: np.ndarray, masks: np.ndarray,
                           color: Optional[Sequence[int]] = None) -> np.ndarray:
    """Per-frame mask overlay for tracking output ([T,H,W,3] + [T,h,w]).
    The mask is enlarged by nearest index, which equals the JAX copy's
    np.kron repeat where H, W are multiples of h, w and, unlike it, also
    covers frames of any other size (a 480x640 frame with 128x128 masks)."""
    out = []
    for f, m in zip(frames, masks):
        if m.shape != f.shape[:2]:
            yi = (np.arange(f.shape[0]) * m.shape[0]) // f.shape[0]
            xi = (np.arange(f.shape[1]) * m.shape[1]) // f.shape[1]
            m = m[yi[:, None], xi[None, :]]
        out.append(draw_binary_mask(f, m, color))
    return np.stack(out)
