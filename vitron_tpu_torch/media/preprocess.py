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
two einsums; "nearest" gathers the source rows and columns JAX's rule
picks. `_resize_hw` also serves SEEM's resizes (images, stroke and
attention masks) and the GLIGEN grounding nets' hint resizes (nearest, and
cubic with `antialias=False` where the JAX code turns it off).
"""
from __future__ import annotations

import numpy as np
import torch

from vitron_tpu_torch.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD, VISION_IMAGE_SIZE


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


def _weight_mat(in_size: int, out_size: int, method: str, antialias: bool = True) -> np.ndarray:
    """[in_size, out_size] float32 resample weights, as
    jax.image.compute_weight_mat builds them (a shrink widens the kernel by
    the scale only with antialias)."""
    f32 = np.float32
    inv = 1.0 / (out_size / in_size)  # a Python float, as in JAX
    inv_scale, kernel_scale = f32(inv), f32(max(inv, 1.0) if antialias else 1.0)
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """jax.image.resize's "nearest" source index of each output pixel:
    floor((i + 0.5) * in / out), computed in float32 as JAX computes it."""
    f32 = np.float32
    offsets = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(in_size) / f32(out_size)
    return np.floor(offsets).astype(np.int64)


def _resize_hw(img: torch.Tensor, nh: int, nw: int, method: str,
               antialias: bool = True) -> torch.Tensor:
    """Separable resample of [..., H, W, C] to [..., nh, nw, C]: "cubic" and
    "linear" by the weight matrices of `_weight_mat`, "nearest" by JAX's
    index rule (`_nearest_index`; antialias does not apply to it)."""
    h, w = img.shape[-3], img.shape[-2]
    if method == "nearest":
        if h != nh:
            img = img[..., torch.from_numpy(_nearest_index(h, nh)).to(img.device), :, :]
        if w != nw:
            img = img[..., torch.from_numpy(_nearest_index(w, nw)).to(img.device), :]
        return img
    if h != nh:
        wh = torch.from_numpy(_weight_mat(h, nh, method, antialias)).to(img.device, img.dtype)
        img = torch.einsum("...hwc,hH->...Hwc", img, wh)
    if w != nw:
        ww = torch.from_numpy(_weight_mat(w, nw, method, antialias)).to(img.device, img.dtype)
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


def resize_normalize_batch(images, out_size: int = VISION_IMAGE_SIZE,
                           mean=OPENAI_DATASET_MEAN, std=OPENAI_DATASET_STD) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> [N, out, out, 3] float32: the short side
    resized to `out_size` by a fractional-scale bilinear sample (no
    antialias), center-cropped, /255 and normalized. The arithmetic of the
    JAX package's `media/native.py::resize_normalize_batch` (its C++ batch
    resize and numpy fallback), in torch on the host: sample coordinates and
    weights in float64, pixels in float32."""
    imgs = torch.from_numpy(np.array(images, np.uint8))  # a writable copy
    outs = []
    for img in imgs:
        h, w = img.shape[:2]
        scale = h / out_size if h <= w else w / out_size
        nh, nw = h / scale, w / scale  # fractional, like the C++ path
        ys = (np.arange(out_size) + (nh - out_size) * 0.5 + 0.5) * scale - 0.5
        xs = (np.arange(out_size) + (nw - out_size) * 0.5 + 0.5) * scale - 0.5
        yf, xf = np.floor(ys).astype(np.int64), np.floor(xs).astype(np.int64)
        wy = torch.from_numpy((ys - yf).astype(np.float32))[:, None, None]
        wx = torch.from_numpy((xs - xf).astype(np.float32))[None, :, None]
        y0, y1 = (torch.from_numpy(np.clip(a, 0, h - 1)) for a in (yf, yf + 1))
        x0, x1 = (torch.from_numpy(np.clip(a, 0, w - 1)) for a in (xf, xf + 1))
        f = img.to(torch.float32)
        v = (f[y0][:, x0] * (1 - wy) * (1 - wx) + f[y0][:, x1] * (1 - wy) * wx
             + f[y1][:, x0] * wy * (1 - wx) + f[y1][:, x1] * wy * wx) / 255.0
        outs.append((v - torch.tensor(mean, dtype=torch.float32))
                    / torch.tensor(std, dtype=torch.float32))
    return torch.stack(outs)


def load_image(path: str) -> np.ndarray:
    """Host-side image decode -> uint8 [H, W, 3] RGB."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def load_video_frames(path: str, num_frames: int = 8) -> np.ndarray:
    """Host-side decode: `num_frames` sampled uniformly -> uint8 [T, H, W, 3],
    through decord, then imageio, whichever is installed (the JAX package's
    `backend="auto"` order without its OpenCV and pytorchvideo branches: the
    port does not import OpenCV, which the card's machine lacks)."""
    try:
        import decord

        vr = decord.VideoReader(path, num_threads=1)
        return vr.get_batch(uniform_frame_indices(len(vr), num_frames).tolist()).asnumpy()
    except ImportError:
        pass
    try:
        import imageio.v3 as iio

        frames = iio.imread(path, plugin="pyav")
        return np.stack([frames[i] for i in uniform_frame_indices(len(frames), num_frames)])
    except ImportError as e:
        raise RuntimeError("no video decode backend available (decord/imageio)") from e
