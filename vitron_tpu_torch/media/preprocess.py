"""Media preprocessing in numpy + PyTorch.

Port of `vitron_tpu/media/preprocess.py`:
- image: /255 -> short-side resize to 224 (Keys cubic, a = -0.5) -> center
  crop -> normalize with the OpenAI CLIP mean/std;
- video: /255 -> normalize -> short-side resize (linear) -> center crop.

The JAX package resizes with `jax.image.resize`, which is a separable
resample whose kernel is widened by the downscale factor (antialiasing).
`F.interpolate` uses another cubic (a = -0.75) and no antialias for
bicubic, so the resample is ported as such: the per-axis weight matrices
are built in numpy exactly as JAX builds them (float32) and applied with
two einsums.
"""
from __future__ import annotations

import numpy as np
import torch

from vitron_tpu.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD, VISION_IMAGE_SIZE


def uniform_frame_indices(num_total: int, num_frames: int) -> np.ndarray:
    """Reference frame sampling: np.linspace(0, N-1, num_frames, dtype=int)."""
    return np.linspace(0, num_total - 1, num_frames, dtype=int)


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def _weight_mat(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[in_size, out_size] float32 resample weights, as
    jax.image.compute_weight_mat(antialias=True) builds them."""
    f32 = np.float32
    inv = 1.0 / (out_size / in_size)  # a Python float, as in JAX
    inv_scale, kernel_scale = f32(inv), f32(max(inv, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def _resize_hw(img: torch.Tensor, nh: int, nw: int, method: str) -> torch.Tensor:
    """Separable resample of [..., H, W, C] to [..., nh, nw, C]."""
    h, w = img.shape[-3], img.shape[-2]
    if h != nh:
        wh = torch.from_numpy(_weight_mat(h, nh, method)).to(img.device, img.dtype)
        img = torch.einsum("...hwc,hH->...Hwc", img, wh)
    if w != nw:
        ww = torch.from_numpy(_weight_mat(w, nw, method)).to(img.device, img.dtype)
        img = torch.einsum("...hwc,wW->...hWc", img, ww)
    return img


def _resize_short_side(img: torch.Tensor, target: int, method: str) -> torch.Tensor:
    h, w = img.shape[-3], img.shape[-2]
    if h <= w:
        nh, nw = target, max(target, int(round(w * target / h)))
    else:
        nh, nw = max(target, int(round(h * target / w))), target
    return _resize_hw(img, nh, nw, method)


def _center_crop(img: torch.Tensor, size: int) -> torch.Tensor:
    h, w = img.shape[-3], img.shape[-2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[..., top:top + size, left:left + size, :]


def _as_float(pixels) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(pixels) if not torch.is_tensor(pixels) else pixels)
    scaled = x.dtype == torch.uint8
    x = x.to(torch.float32)
    return x / 255.0 if scaled else x


def _normalize(x: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(OPENAI_DATASET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(OPENAI_DATASET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def preprocess_image(pixels, size: int = VISION_IMAGE_SIZE) -> torch.Tensor:
    """uint8/float [..., H, W, 3] (numpy or tensor) -> normalized
    [..., size, size, 3] float32 tensor on the input's device."""
    x = _resize_short_side(_as_float(pixels), size, "cubic")
    return _normalize(_center_crop(x, size))


def preprocess_video(frames, size: int = VISION_IMAGE_SIZE) -> torch.Tensor:
    """uint8/float [T, H, W, 3] (pre-sampled frames) -> [T, size, size, 3]
    float32. The reference's random horizontal flip is not ported (it is
    off by default in the JAX package too)."""
    x = _resize_short_side(_normalize(_as_float(frames)), size, "linear")
    return _center_crop(x, size)
