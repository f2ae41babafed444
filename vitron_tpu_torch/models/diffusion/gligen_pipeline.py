"""GLIGEN grounded text-to-image generation and inpainting.

Port of `vitron_tpu/models/diffusion/gligen_pipeline.py` (:34-268):
per-phrase pooled CLIP features padded to `max_objs` slots, prompt and
negative-prompt contexts from the CLIP text encoder, 50 PLMS steps with the
gated-attention alpha schedule and classifier-free guidance batched cond +
uncond in one UNet call per step, the inpainting stream (VAE-encoded source,
keep-mask from boxes at latent resolution, per-step noised composite, mask
and masked latent as 5 extra UNet input channels), and the VAE decode.

`generate` = `prepare` (the host half: tokenization, box packing, the
source resize), the random draws from an explicit `torch.Generator` (the
initial latent x_T and, for inpainting, one noise tensor per step), then
`run` (the device half), which takes those draws as inputs: a caller can
hand it the same x_T and noise as the JAX `run` body draws. `GligenStylePipeline` and the checkpoint loader
wait (ROADMAP A9, A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vitron_tpu_torch.models.diffusion import clip_text, samplers, unet2d, vae
from vitron_tpu_torch.models.diffusion.vae import SD_SCALE_FACTOR


@dataclasses.dataclass(frozen=True)
class GligenConfig:
    unet: unet2d.UNetConfig = dataclasses.field(default_factory=unet2d.UNetConfig.sd_v1)
    vae: vae.VAEConfig = dataclasses.field(default_factory=vae.VAEConfig.sd)
    text: clip_text.TextConfig = dataclasses.field(default_factory=clip_text.TextConfig.clip_l)
    image_size: int = 512
    max_objs: int = 30
    steps: int = 50

    @property
    def latent_size(self) -> int:
        return self.image_size // (2 ** (len(self.vae.channel_mult) - 1))

    @staticmethod
    def tiny(**kw) -> "GligenConfig":
        base = dict(unet=unet2d.UNetConfig.tiny(), vae=vae.VAEConfig.tiny(),
                    text=clip_text.TextConfig.tiny(hidden_size=16, num_heads=2,
                                                   intermediate_size=32),
                    image_size=32, max_objs=4, steps=4)
        base.update(kw)
        return GligenConfig(**base)


def pack_grounding(boxes: Sequence[Sequence[float]], phrase_features: np.ndarray, max_objs: int,
                   context_dim: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad boxes, slot masks and phrase features to `max_objs` slots."""
    out_boxes = np.zeros((max_objs, 4), np.float32)
    out_masks = np.zeros((max_objs,), np.float32)
    out_text = np.zeros((max_objs, context_dim), np.float32)
    for i in range(min(len(boxes), max_objs)):
        out_boxes[i] = np.asarray(boxes[i], np.float32)
        out_masks[i] = 1.0
        out_text[i] = phrase_features[i]
    return out_boxes, out_masks, out_text


def keep_mask_from_boxes(boxes: Sequence[Sequence[float]], size: int) -> np.ndarray:
    """1 = keep, 0 inside the (normalised xyxy) boxes."""
    m = np.ones((size, size), np.float32)
    for bx in boxes:
        m[int(bx[1] * size):int(bx[3] * size), int(bx[0] * size):int(bx[2] * size)] = 0.0
    return m


class GligenPipeline:
    """Resident params for generation and inpainting on one device."""

    def __init__(self, cfg: GligenConfig, unet_params, vae_params, text_params,
                 inpaint_unet_params=None, tokenizer=None):
        self.cfg = cfg
        self.unet_params = unet_params
        self.inpaint_unet_params = inpaint_unet_params
        self.vae_params = vae_params
        self.text_params = text_params
        self.tokenizer = tokenizer
        self.device = text_params["token_emb"].device

    def tokenize(self, texts: List[str]) -> np.ndarray:
        tok = self.tokenizer(texts, padding="max_length", max_length=self.cfg.text.max_length,
                             truncation=True, return_tensors="np")
        return np.asarray(tok["input_ids"])

    def _eps_fn(self, params, context, uc_context, boxes, masks, text_emb, guidance_scale,
                extra_channels=None):
        cfg = self.cfg
        objs = unet2d.grounding_tokens(params, boxes, masks, text_emb)
        objs2 = torch.cat([objs, objs], dim=0)
        ctx2 = torch.cat([context, uc_context], dim=0)

        def eps(x, t, gate):
            x_in = x
            if extra_channels is not None:
                extra = extra_channels.expand(x.shape[:-1] + (extra_channels.shape[-1],))
                x_in = torch.cat([x, extra], dim=-1)
            if guidance_scale == 1.0:
                tt = torch.full((x.shape[0],), t, dtype=torch.int64, device=x.device)
                return unet2d.forward(params, cfg.unet, x_in, tt, context, objs, gate)
            xx = torch.cat([x_in, x_in], dim=0)
            tt = torch.full((xx.shape[0],), t, dtype=torch.int64, device=x.device)
            e_c, e_uc = unet2d.forward(params, cfg.unet, xx, tt, ctx2, objs2, gate).chunk(2)
            return e_uc + guidance_scale * (e_c - e_uc)

        return eps

    def prepare(self, prompt: str, boxes: Sequence[Sequence[float]], phrases: Sequence[str],
                negative_prompt: str = "", inpaint_image: Optional[np.ndarray] = None,
                inpaint_keep_mask: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Host half of `generate`: tokens, packed boxes, the inpainting
        source and keep-mask, as `run`'s keyword arguments on the device."""
        cfg = self.cfg
        dev = self.device
        is_inpaint = inpaint_image is not None
        ids_ctx = self.tokenize([prompt])
        # inpainting uses the prompt as the unconditional context too
        ids_uc = self.tokenize([prompt if is_inpaint else negative_prompt])
        # unused phrase slots hold a lone BOS so argmax-EOS stays defined
        phrase_ids = np.zeros((cfg.max_objs, cfg.text.max_length), np.int64)
        phrase_ids[:, 0] = 1
        n = min(len(phrases), cfg.max_objs)
        if n:
            phrase_ids[:n] = self.tokenize(list(phrases)[:n])
        gb, gm, _ = pack_grounding(boxes, np.zeros((n, cfg.text.hidden_size)), cfg.max_objs,
                                   cfg.text.hidden_size)
        img = keep = None
        if is_inpaint:
            img = np.asarray(inpaint_image)
            if img.shape[:2] != (cfg.image_size, cfg.image_size):
                # resized (not cropped) so normalised boxes stay on the frame
                from PIL import Image

                img = np.asarray(Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).resize(
                    (cfg.image_size, cfg.image_size), Image.BILINEAR))
            keep = (inpaint_keep_mask if inpaint_keep_mask is not None
                    else keep_mask_from_boxes(boxes, cfg.latent_size))
        params = self.unet_params
        if is_inpaint and self.inpaint_unet_params is not None:
            params = self.inpaint_unet_params

        def t(a, dtype=torch.float32):
            return None if a is None else torch.as_tensor(np.array(a), dtype=dtype, device=dev)

        return {"params": params, "ids_ctx": t(ids_ctx, torch.int64),
                "ids_uc": t(ids_uc, torch.int64), "phrase_ids": t(phrase_ids, torch.int64),
                "gb": t(gb)[None], "gm": t(gm)[None], "inpaint_img": t(img),
                "keep_mask": t(keep)}

    def generate(self, prompt: str, boxes: Sequence[Sequence[float]], phrases: Sequence[str],
                 negative_prompt: str = "", guidance_scale: float = 7.5,
                 alpha_type: Sequence[float] = (0.3, 0.0, 0.7),
                 gen: Optional[torch.Generator] = None, steps: Optional[int] = None,
                 inpaint_image: Optional[np.ndarray] = None,
                 inpaint_keep_mask: Optional[np.ndarray] = None) -> torch.Tensor:
        """-> [H, W, 3] uint8 image on the pipeline's device. `gen` (a
        generator on that device; seed 0 when None) draws x_T and the
        inpainting noise. inpaint_image is [H, W, 3] in [0, 255]."""
        cfg = self.cfg
        steps = steps or cfg.steps
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        inputs = self.prepare(prompt, boxes, phrases, negative_prompt, inpaint_image,
                              inpaint_keep_mask)
        shape = (1, cfg.latent_size, cfg.latent_size, cfg.unet.out_channels)
        x_t = torch.randn(shape, generator=gen, device=self.device)
        noise = (torch.randn((steps,) + shape, generator=gen, device=self.device)
                 if inpaint_image is not None else None)
        return self.run(**inputs, x_t=x_t, steps=steps, guidance_scale=float(guidance_scale),
                        alpha_type=tuple(alpha_type), blend_noise=noise)

    def run(self, params, ids_ctx, ids_uc, phrase_ids, gb, gm, x_t, steps: int,
            guidance_scale: float, alpha_type: Tuple[float, ...], inpaint_img=None,
            keep_mask=None, blend_noise=None) -> torch.Tensor:
        """Device half of `generate`: text encoding, grounding, PLMS from
        x_t [1, h, w, 4], VAE decode -> [H, W, 3] uint8. Inpainting passes
        inpaint_img [H, W, 3] in [0, 255], keep_mask [h, w] and blend_noise
        [steps, 1, h, w, 4]."""
        cfg = self.cfg
        sched = samplers.DiffusionSchedule.create("linear", 1000, 0.00085, 0.012)
        gates = samplers.alpha_generator(steps, alpha_type)
        context = clip_text.encode(self.text_params, cfg.text, ids_ctx)
        uc = clip_text.encode(self.text_params, cfg.text, ids_uc)
        hidden = clip_text.encode(self.text_params, cfg.text, phrase_ids)
        eos = phrase_ids.argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device), eos]
        gt = (pooled * gm[0][:, None]).to(torch.float32)[None]
        extra = mask_blend = None
        if inpaint_img is not None:
            img = (inpaint_img / 255.0 - 0.5) / 0.5
            mean, _ = vae.encode(self.vae_params, cfg.vae, img[None])
            x0 = mean * SD_SCALE_FACTOR
            keep = keep_mask[None, :, :, None]
            extra = torch.cat([x0 * keep, keep], dim=-1)[0]
            mask_blend = (keep, x0, blend_noise)
        eps = self._eps_fn(params, context, uc, gb, gm, gt, guidance_scale,
                           extra_channels=extra)
        x = samplers.plms_sample(eps, x_t, sched, steps, gate_alphas=gates,
                                 mask_blend=mask_blend)
        img = vae.decode(self.vae_params, cfg.vae, x / SD_SCALE_FACTOR)[0]
        img = img.clamp(-1, 1) * 0.5 + 0.5
        return (img * 255).to(torch.uint8)
