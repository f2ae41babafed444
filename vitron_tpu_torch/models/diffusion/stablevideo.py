"""StableVideo: atlas-based video editing with ControlNet (task F).

Port of `vitron_tpu/models/diffusion/stablevideo.py` (reference
modules/StableVideo). A video is represented by Neural Layered Atlases:
IMLP networks map (x, y, t) pixels to foreground / background atlas UVs
and an alpha. Editing:

- the background: ControlNet img2img on the background atlas (depth
  ControlNet when a DPT annotator is given, canny otherwise);
- the foreground: a canny ControlNet edit of each keyframe, the first from
  pure noise, each later one from the previous keyframe's atlas mapped
  through its UVs (stochastic encode at strength * T, then DDIM),
  alpha-multiplied, scattered back to atlas space (scipy `griddata` on the
  host), median-aggregated, optionally refined by a small AGGNet;
- the render: a bilinear grid-sample of the edited atlases at every
  frame's UVs and an alpha blend, all frames at once on the device.

Every ControlNet + UNet call runs the port's SD UNet block plan, so B2
(flash at >= VITRON_FLASH_MIN tokens), B3 (GEGLU) and B8 (group-norm sums)
carry the edit on the card; the VAE adds B2 at D 512 and B8. The canny
hint is the port's own (`canny`, OpenCV's algorithm in numpy: the card's
machine has no OpenCV). `edit_image` refuses sizes whose latent the UNet's
down and up path cannot return to its skips (ROADMAP C12).
`convert_imlp_torch` (:78) reads a torch IMLP state dict into the param
tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitron_tpu_torch.media.preprocess import _resize_hw
from vitron_tpu_torch.models.diffusion.layers import lin_w, reading

# ----------------------------------------------------------------- IMLP


@dataclasses.dataclass(frozen=True)
class IMLPConfig:
    input_dim: int = 3
    hidden_dim: int = 256
    output_dim: int = 2
    num_layers: int = 8
    positional_dim: int = 10  # frequencies of the positional encoding
    skip_layers: Tuple[int, ...] = (4, 7)


def positional_encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """[..., D] -> [..., D * 2 * num_freqs]: sin, cos at pi * 2^i."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=x.device) * np.pi
    ang = x[..., None, :] * freqs[:, None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(x.shape[:-1] + (-1,))


def imlp_forward(params: Dict[str, Any], cfg: IMLPConfig, x: torch.Tensor,
                 use_tanh: bool = True) -> torch.Tensor:
    """x [..., input_dim] in [-1, 1] -> [..., output_dim]."""
    inp = positional_encode(x, cfg.positional_dim) if cfg.positional_dim > 0 else x
    h = inp
    for i, layer in enumerate(params["layers"]):
        if i in cfg.skip_layers:
            h = torch.cat([h, inp], dim=-1)
        h = h @ layer["w"] + layer["b"]
        if i < len(params["layers"]) - 1:
            h = torch.clamp(h, min=0.0)
    return torch.tanh(h) if use_tanh else h


def imlp_init(gen: torch.Generator, cfg: IMLPConfig, device) -> Dict[str, Any]:
    """Random IMLP params with the JAX init's scales (`gen` on `device`)."""
    in_dim = cfg.input_dim * 2 * cfg.positional_dim if cfg.positional_dim else cfg.input_dim
    dims = [in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1) + [cfg.output_dim]
    layers = []
    for i in range(cfg.num_layers):
        d_in = dims[i] + (in_dim if i in cfg.skip_layers else 0)
        w = torch.randn((d_in, dims[i + 1]), generator=gen, dtype=torch.float32, device=device)
        layers.append({"w": w / math.sqrt(d_in),
                       "b": torch.zeros((dims[i + 1],), dtype=torch.float32, device=device)})
    return {"layers": layers}


IMLP_STEMS = ("hidden", "hidden_layers", "layers")


def convert_imlp_torch(sd, prefix: str = "", device="cpu") -> Dict[str, Any]:
    """A torch IMLP state dict -> param tree on `device`. The released NLA
    checkpoints name the stack `hidden.{i}`; `layers.{i}` / `hidden_layers.{i}`
    are accepted for other IMLP exports."""
    sd = reading(sd, device)
    weights = {k for k in sd if k.endswith(".weight")}
    layers = []
    for i in range(len(weights)):  # layers 0, 1, ... up to the first one missing
        stem = next((f"{prefix}{nm}.{i}" for nm in IMLP_STEMS
                     if f"{prefix}{nm}.{i}.weight" in weights), None)
        if stem is None:
            break
        layers.append({"w": lin_w(sd, stem + ".weight"), "b": sd[stem + ".bias"]})
    if not layers:
        raise ValueError(f"no IMLP layers found under prefix {prefix!r}; keys look like "
                         f"{sorted(sd)[:3]}")
    return {"layers": layers}


# ----------------------------------------------------------------- render


def grid_sample_bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """F.grid_sample(align_corners=True) as the JAX package computes it:
    img [H, W, C], uv [..., 2] in [-1, 1] (x, y) -> [..., C]; the corners
    clamped into the image."""
    h, w, _ = img.shape
    x = (uv[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (uv[..., 1] + 1.0) * 0.5 * (h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1).to(torch.int64)
    y0 = torch.clamp(torch.floor(y), 0, h - 1).to(torch.int64)
    x1, y1 = torch.clamp(x0 + 1, max=w - 1), torch.clamp(y0 + 1, max=h - 1)
    wx, wy = x - x0, y - y0
    return (img[y0, x0] * ((1 - wy) * (1 - wx))[..., None]
            + img[y0, x1] * ((1 - wy) * wx)[..., None]
            + img[y1, x0] * (wy * (1 - wx))[..., None]
            + img[y1, x1] * (wy * wx)[..., None])


def render_frames(fg_atlas: torch.Tensor, bg_atlas: torch.Tensor, fg_uv: torch.Tensor,
                  bg_uv: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Alpha-composite the atlases into frames: atlases [Ha, Wa, 3] in [0,
    1], UVs [T, H, W, 2] in [-1, 1], alpha [T, H, W, 1] -> [T, H, W, 3]."""
    fg = grid_sample_bilinear(fg_atlas, fg_uv)
    bg = grid_sample_bilinear(bg_atlas, bg_uv)
    return fg * alpha + bg * (1.0 - alpha)


def atlas_uvs(fg_mlp, bg_mlp, alpha_mlp, imlp_cfgs, t_frames: int, h: int, w: int,
              fg_uv_scale=None, bg_uv_scale=None, max_frames: Optional[int] = None):
    """The IMLP mapping networks on the full (x, y, t) grid, a frame at a
    time: pixel x and y normalized by max(h, w) / 2 and t by max_frames / 2
    (the released checkpoints' conventions), the alpha head 0.5 (tanh + 1)
    then 0.99 a + 0.001. -> fg_uv, bg_uv [T, H, W, 2] and alpha [T, H, W, 1]."""
    dev = fg_mlp["layers"][0]["w"].device
    half = max(h, w) / 2.0
    ys = torch.arange(h, dtype=torch.float32, device=dev) / half - 1.0
    xs = torch.arange(w, dtype=torch.float32, device=dev) / half - 1.0
    mf = float(max_frames if max_frames is not None else t_frames)
    ts = torch.arange(t_frames, dtype=torch.float32, device=dev) / (mf / 2.0) - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    fgs, bgs, alphas = [], [], []
    for tv in ts:
        pts = torch.stack([gx, gy, torch.full_like(gx, float(tv))], dim=-1)
        fgs.append(imlp_forward(fg_mlp, imlp_cfgs["fg"], pts))
        bgs.append(imlp_forward(bg_mlp, imlp_cfgs["bg"], pts))
        a = imlp_forward(alpha_mlp, imlp_cfgs["alpha"], pts, use_tanh=False)
        alphas.append(0.99 * (0.5 * (torch.tanh(a) + 1.0)) + 0.001)
    fg, bg, a = torch.stack(fgs), torch.stack(bgs), torch.stack(alphas)
    if fg_uv_scale is not None:
        fg = fg * fg_uv_scale
    if bg_uv_scale is not None:
        bg = bg * bg_uv_scale
    return fg, bg, a


# ----------------------------------------------------------------- hints

_TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)  # OpenCV's tan(22.5) << 15


def _sobel(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """3x3 Sobel dx, dy of [H, W, C] with replicated borders, int32."""
    p = np.pad(img.astype(np.int32), ((1, 1), (1, 1), (0, 0)), mode="edge")
    h, w = img.shape[:2]

    def at(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)) - (at(-1, -1) + 2 * at(0, -1) + at(1, -1))
    gy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))
    return gx, gy


def canny(image_uint8: np.ndarray, low: float, high: float) -> np.ndarray:
    """OpenCV's Canny (aperture 3, L1 gradient) in numpy -> uint8 [H, W]
    of 0 / 255. 3x3 Sobel with replicated borders; per pixel the channel of
    the largest |dx| + |dy| (the first on a tie) gives the magnitude and the
    direction; non-maximum suppression in four directions (tan 22.5 and
    67.5 in OpenCV's fixed point, '>' on one side and '>=' on the other
    horizontally and vertically, '>' on both diagonally; magnitudes outside
    the image are 0); pixels above `low` that survive are edges when above
    `high`, and weak edges join them by 8-connected hysteresis."""
    from scipy import ndimage

    img = np.asarray(image_uint8)
    if img.ndim == 2:
        img = img[..., None]
    dx, dy = _sobel(img)
    mag = np.abs(dx) + np.abs(dy)
    best = np.argmax(mag, axis=-1)[..., None]  # the first channel of the largest magnitude
    m = np.take_along_axis(mag, best, -1)[..., 0]
    dx = np.take_along_axis(dx, best, -1)[..., 0]
    dy = np.take_along_axis(dy, best, -1)[..., 0]
    h, w = m.shape
    mp = np.pad(m, 1)

    def nb(oy, ox):
        return mp[1 + oy:1 + oy + h, 1 + ox:1 + ox + w]

    ax = np.abs(dx).astype(np.int64)
    ay = np.abs(dy).astype(np.int64) << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    horiz = ay < tg22x
    vert = ~horiz & (ay > tg67x)
    diag = ~horiz & ~vert
    s = np.where((dx ^ dy) < 0, -1, 1)
    keep = np.where(horiz, (m > nb(0, -1)) & (m >= nb(0, 1)), False)
    keep |= vert & (m > nb(-1, 0)) & (m >= nb(1, 0))
    diag_pos = (m > nb(-1, -1)) & (m > nb(1, 1))    # s = 1: the (x - 1, y - 1) diagonal
    diag_neg = (m > nb(-1, 1)) & (m > nb(1, -1))    # s = -1
    keep |= diag & np.where(s > 0, diag_pos, diag_neg)
    cand = keep & (m > int(np.floor(low)))
    strong = cand & (m > int(np.floor(high)))
    labels, _ = ndimage.label(cand, structure=np.ones((3, 3), int))
    edge = np.isin(labels, np.unique(labels[strong])) & cand
    return (edge * 255).astype(np.uint8)


def canny_hint(image_uint8: np.ndarray, low: int = 100, high: int = 200) -> np.ndarray:
    """The canny edge hint [H, W, 3] float32 in {0, 1} (the reference
    annotator's cv2.Canny(image, 100, 200))."""
    edges = canny(image_uint8, low, high)
    return (np.stack([edges] * 3, axis=-1) / 255.0).astype(np.float32)


def depth_hint(depth_params, depth_cfg, image_uint8: np.ndarray) -> np.ndarray:
    """The DPT depth hint of the depth-ControlNet background edit."""
    from vitron_tpu_torch.models.diffusion import depth as depth_mod

    return depth_mod.depth_hint(depth_params, depth_cfg, image_uint8)


def scatter_to_atlas(edited_frame: np.ndarray, uv: np.ndarray,
                     atlas_hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Map an edited keyframe back to atlas space by linear scipy griddata
    on the host: uv [H, W, 2] in [-1, 1] -> (atlas [Ha, Wa, C] float32,
    covered mask [Ha, Wa])."""
    from scipy.interpolate import griddata

    ha, wa = atlas_hw
    pts_x = (uv[..., 0].reshape(-1) + 1) * 0.5 * (wa - 1)
    pts_y = (uv[..., 1].reshape(-1) + 1) * 0.5 * (ha - 1)
    vals = edited_frame.reshape(-1, edited_frame.shape[-1])
    gy, gx = np.mgrid[0:ha, 0:wa]
    out = griddata(np.stack([pts_y, pts_x], axis=1), vals, (gy, gx), method="linear")
    valid = ~np.isnan(out[..., 0])
    return np.nan_to_num(out).astype(np.float32), valid


# ----------------------------------------------------------------- editing


class StableVideoEditor:
    """Edits atlases with ControlNet and re-renders them. Holds the canny
    ControlNet (and optionally the depth ControlNet and its DPT annotator),
    the SD UNet, VAE and CLIP text params, resident on their device."""

    def __init__(self, unet_cfg, unet_params, control_params, vae_cfg, vae_params, text_cfg,
                 text_params, tokenizer=None, depth_control_params=None, depth_annotator=None):
        """control_params: the canny ControlNet; depth_control_params: the
        depth ControlNet of background edits; depth_annotator: (DPT params,
        DPTConfig) for its hint."""
        self.unet_cfg = unet_cfg
        self.unet_params = unet_params
        self.control_params = control_params
        self.vae_cfg = vae_cfg
        self.vae_params = vae_params
        self.text_cfg = text_cfg
        self.text_params = text_params
        self.tokenizer = tokenizer
        self.depth_control_params = depth_control_params
        self.depth_annotator = depth_annotator
        self.device = unet_params["time_w1"].device

    @property
    def size_multiple(self) -> int:
        """Image sides must be multiples of this: the VAE's factor times the
        UNet's down path (8 x 2^(levels - 1), 64 for SD), so every latent
        level comes back up to its skip's size (ROADMAP C12)."""
        return 2 ** (len(self.vae_cfg.channel_mult) - 1) * 2 ** (len(self.unet_cfg.channel_mult)
                                                              - 1)

    def check_size(self, h: int, w: int) -> None:
        m = self.size_multiple
        if h % m or w % m:
            raise ValueError(
                f"edit_image: a {h}x{w} image is not a multiple of {m} on both sides: the "
                f"UNet's skip concat would meet a level of another size (ROADMAP C12); "
                f"resize it to multiples of {m} first")

    def noise(self, shape, gen: Optional[torch.Generator]) -> torch.Tensor:
        """The edit's initial noise, float32 from `gen` on the editor's device."""
        dev = gen.device if gen is not None else self.device
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=dev).to(self.device)

    def edit_image(self, image, hint, prompt: str, negative_prompt: str = "",
                   strength: float = 0.9, steps: int = 20, guidance_scale: float = 9.0,
                   gen: Optional[torch.Generator] = None, noise: Optional[torch.Tensor] = None,
                   init_latent: Optional[torch.Tensor] = None, from_noise: bool = False,
                   control: str = "canny") -> torch.Tensor:
        """ControlNet img2img: stochastic-encode the image's latent at
        strength * T (or start from pure noise with `from_noise`), then DDIM
        with the control residuals and classifier-free guidance. image
        [H, W, 3] uint8; hint [H, W, 3] float in [0, 1]; `noise` (the latent's
        shape, [1, H/8, W/8, 4]) or else drawn from `gen`. -> [H, W, 3] uint8
        on the device. With `from_noise` the image only gives the size (its
        latent, which JAX encodes and drops, is not computed)."""
        from vitron_tpu_torch.models.diffusion import clip_text, controlnet, samplers, vae
        from vitron_tpu_torch.models.diffusion.vae import SD_SCALE_FACTOR

        dev = self.device
        t_enc = (steps - 1) if from_noise else min(int(strength * steps), steps - 1)
        ds = 2 ** (len(self.vae_cfg.channel_mult) - 1)
        if init_latent is None:
            h, w = int(np.shape(image)[0]), int(np.shape(image)[1])
            self.check_size(h, w)
            lh, lw = h // ds, w // ds
        else:
            lh, lw = int(init_latent.shape[1]), int(init_latent.shape[2])
            self.check_size(lh * ds, lw * ds)
        shape = (1, lh, lw, 4)
        if noise is None:
            noise = self.noise(shape, gen)
        noise = noise.to(dev, torch.float32)
        cfg = self.unet_cfg
        sched = samplers.DiffusionSchedule.create("linear", 1000, 0.00085, 0.012)
        ts, alphas, alphas_prev, _ = samplers.make_ddim_arrays(sched, steps, 0.0)
        tok = self.tokenizer([prompt, negative_prompt], padding="max_length",
                             max_length=self.text_cfg.max_length, truncation=True,
                             return_tensors="np")
        ctx2 = clip_text.encode(self.text_params, self.text_cfg,
                                torch.as_tensor(np.asarray(tok["input_ids"]), device=dev))
        hint = torch.as_tensor(np.asarray(hint) if not torch.is_tensor(hint) else hint,
                               dtype=torch.float32).to(dev)
        if tuple(hint.shape[:2]) != (lh * 8, lw * 8):  # the hint encoder downsamples 8x
            hint = _resize_hw(hint, lh * 8, lw * 8, "linear")
        hint2 = torch.stack([hint, hint])
        cp = (self.depth_control_params if control == "depth"
              and self.depth_control_params is not None else self.control_params)
        if from_noise:
            x = noise
        else:
            if init_latent is None:
                img = torch.as_tensor(np.asarray(image) if not torch.is_tensor(image) else image)
                img = (img.to(dev, torch.float32) / 255.0 - 0.5) / 0.5
                mean, _ = vae.encode(self.vae_params, self.vae_cfg, img[None])
                init = mean * SD_SCALE_FACTOR
            else:
                init = init_latent.to(dev, torch.float32)
            a_enc = np.float32(alphas[t_enc])  # ldm's stochastic_encode at step t_enc
            x = float(np.sqrt(a_enc)) * init + float(np.sqrt(np.float32(1) - a_enc)) * noise
        for i in range(t_enc, -1, -1):
            xx = torch.cat([x, x])
            tt = torch.full((2,), int(ts[i]), dtype=torch.int64, device=dev)
            ctrl = controlnet.control_residuals(cp, cfg, xx, hint2, tt, ctx2)
            e_c, e_uc = controlnet.controlled_forward(self.unet_params, cfg, xx, tt, ctx2,
                                                      ctrl).chunk(2)
            e = e_uc + guidance_scale * (e_c - e_uc)
            x, _ = samplers._x_prev(x, e, alphas[i], alphas_prev[i])
        out = vae.decode(self.vae_params, self.vae_cfg, x / SD_SCALE_FACTOR)[0]
        out = torch.clamp(out, -1, 1) * 0.5 + 0.5
        return (out * 255).to(torch.uint8)


def advanced_edit_foreground(editor: StableVideoEditor, keyframes: List[np.ndarray],
                             keyframe_uvs: List[np.ndarray], keyframe_alphas: List[np.ndarray],
                             atlas_hw: Tuple[int, int], prompt: str, negative_prompt: str = "",
                             strength: float = 0.9, steps: int = 20,
                             guidance_scale: float = 9.0,
                             gen: Optional[torch.Generator] = None,
                             noises: Optional[List[torch.Tensor]] = None,
                             aggnet_refine: bool = False, aggnet_epochs: int = 50,
                             aggnet_lr: float = 1e-3) -> np.ndarray:
    """The reference foreground flow: a canny ControlNet edit of each
    keyframe -- the first from pure noise, each later one from the previous
    keyframe's atlas sampled at its own UVs (stochastic encode at
    strength * T) -- alpha-multiplied, scattered to atlas space (griddata on
    the host), median-aggregated over the keyframes, optionally refined by
    an AGGNet trained to reproduce the edited keyframes. `noises` (one a
    keyframe) or `gen` give each edit's noise. -> the aggregated foreground
    atlas [Ha, Wa, 3] float32 in [0, 1] (numpy)."""
    dev = editor.device
    n = len(keyframes)
    per_kf_atlas = np.zeros((n,) + tuple(atlas_hw) + (3,), np.float32)
    edited_list = []
    for i in range(n):
        kf = np.asarray(keyframes[i])
        hint = canny_hint(kf)
        noise = noises[i] if noises is not None else None
        if i == 0:
            edited = editor.edit_image(kf, hint, prompt, negative_prompt, steps=steps,
                                       guidance_scale=guidance_scale, gen=gen, noise=noise,
                                       from_noise=True)
        else:
            mapped = grid_sample_bilinear(torch.from_numpy(per_kf_atlas[i - 1]).to(dev),
                                          torch.as_tensor(np.asarray(keyframe_uvs[i]),
                                                          dtype=torch.float32, device=dev))
            mapped = (torch.clamp(mapped, 0.0, 1.0) * 255).to(torch.uint8)
            edited = editor.edit_image(mapped, hint, prompt, negative_prompt, strength=strength,
                                       steps=steps, guidance_scale=guidance_scale, gen=gen,
                                       noise=noise)
        edited_f = edited.cpu().numpy().astype(np.float32) / 255.0
        edited_f = edited_f * np.asarray(keyframe_alphas[i])
        edited_list.append(edited_f)
        per_kf_atlas[i], _ = scatter_to_atlas(edited_f, np.asarray(keyframe_uvs[i]), atlas_hw)
    agg = np.median(per_kf_atlas, axis=0)
    if aggnet_refine and n > 1:
        agg = _aggnet_refine(torch.from_numpy(agg).to(dev),
                             [torch.from_numpy(e).to(dev) for e in edited_list],
                             [torch.as_tensor(np.asarray(u), dtype=torch.float32, device=dev)
                              for u in keyframe_uvs],
                             epochs=aggnet_epochs, lr=aggnet_lr).cpu().numpy()
    return agg


# ----------------------------------------------------------------- AGGNet


def aggnet_forward(p: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The atlas refinement net (reference stablevideo/aggnet.py): conv3x3
    (3 -> 64) + ReLU + conv3x3 (64 -> 3), residual; x [B, H, W, 3]."""
    xc = x.permute(0, 3, 1, 2)
    h = F.relu(F.conv2d(xc, p["w1"].permute(3, 2, 0, 1).to(x.dtype), padding=1))
    h = F.conv2d(h, p["w2"].permute(3, 2, 0, 1).to(x.dtype), padding=1)
    return x + h.permute(0, 2, 3, 1)


def aggnet_init(gen: torch.Generator, device) -> Dict[str, Any]:
    return {"w1": torch.randn((3, 3, 3, 64), generator=gen, device=device) / np.sqrt(27),
            "w2": torch.randn((3, 3, 64, 3), generator=gen, device=device) / np.sqrt(576)}


def _aggnet_refine(agg_atlas: torch.Tensor, edited_frames: List[torch.Tensor],
                   uvs: List[torch.Tensor], epochs: int = 50, lr: float = 1e-3,
                   params: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """AGGNet refinement: train the net with SGD and momentum 0.9 (optax's
    `sgd(lr, momentum=0.9)`: v = 0.9 v + g, w -= lr v) so that sampling the
    refined atlas at each keyframe's UVs reproduces the edited keyframe
    (L1), then apply it once. `params` defaults to a seeded init."""
    dev = agg_atlas.device
    if params is None:
        params = aggnet_init(torch.Generator(device=dev).manual_seed(0), dev)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.SGD(list(p.values()), lr=lr, momentum=0.9)
    for _ in range(epochs):
        with torch.enable_grad():
            refined = aggnet_forward(p, agg_atlas[None])[0]
            loss = sum(torch.mean(torch.abs(torch.clamp(grid_sample_bilinear(refined, uv),
                                                         0.0, 1.0) - e))
                       for e, uv in zip(edited_frames, uvs))
            opt.zero_grad()
            loss.backward()
        opt.step()
    with torch.no_grad():
        return aggnet_forward(p, agg_atlas[None])[0]


# ----------------------------------------------------------------- task F


def edit_video(editor: StableVideoEditor, atlas: Dict[str, Any], fore_prompt: str,
               back_prompt: str, num_keyframes: int = 3,
               noise_source: Optional[Callable] = None) -> np.ndarray:
    """Task F on an atlas bundle ({"fg_atlas", "bg_atlas" [Ha, Wa, 3] in
    [0, 1], "fg_uv", "bg_uv" [T, H, W, 2], "alpha" [T, H, W, 1]}): the
    foreground edit over `num_keyframes` evenly spaced keyframes (when
    `fore_prompt`), the background edit (depth ControlNet when the editor
    has an annotator, canny otherwise; when `back_prompt`), the render.
    -> frames [T, H, W, 3] uint8 (numpy)."""
    dev = editor.device

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=dev)

    fg_atlas, bg_atlas = t(atlas["fg_atlas"]), t(atlas["bg_atlas"])
    fg_uv, alpha = np.asarray(atlas["fg_uv"]), np.asarray(atlas["alpha"])
    t_frames = fg_uv.shape[0]
    if fore_prompt:
        idxs = sorted(set(np.linspace(0, t_frames - 1,
                                      min(num_keyframes, t_frames)).astype(int)))
        kfs = [(torch.clamp(grid_sample_bilinear(fg_atlas, t(fg_uv[k])), 0, 1) * 255)
               .to(torch.uint8).cpu().numpy() for k in idxs]
        noises = [noise_source(i) for i in range(len(idxs))] if noise_source else None
        fg_edited = t(advanced_edit_foreground(editor, kfs, [fg_uv[k] for k in idxs],
                                               [alpha[k] for k in idxs],
                                               tuple(fg_atlas.shape[:2]), fore_prompt,
                                               noises=noises))
    else:
        fg_edited = fg_atlas
    if back_prompt:
        bg_u8 = (torch.clamp(bg_atlas, 0, 1) * 255).to(torch.uint8).cpu().numpy()
        if editor.depth_annotator is not None:
            hint, ctrl = depth_hint(*editor.depth_annotator, bg_u8), "depth"
        else:
            hint, ctrl = canny_hint(bg_u8), "canny"
        edited = editor.edit_image(bg_u8, hint, back_prompt, control=ctrl,
                                   noise=noise_source("back") if noise_source else None)
        bg_edited = edited.to(torch.float32) / 255.0
    else:
        bg_edited = bg_atlas
    frames = render_frames(fg_edited, bg_edited, t(fg_uv), t(atlas["bg_uv"]), t(alpha))
    return (torch.clamp(frames, 0, 1) * 255).to(torch.uint8).cpu().numpy()
