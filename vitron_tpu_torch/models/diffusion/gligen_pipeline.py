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
hand it the same x_T and noise as the JAX `run` body draws.

`GligenStylePipeline` (:283) is the text + image grounded pipeline of
GLIGEN's style checkpoints: each box carries a phrase's pooled CLIP text
feature and a style crop's pooled CLIP image feature (ViT-L/14 through
`vit.forward_pooled`, the visual projection, and GLIGEN's projection matrix
through `reproject_image_feature`), which `layers.position_net_with_image`
turns into 2 x max_objs grounding tokens. `generate_styled` splits the same
way: `prepare_styled` on the host, then `run_styled` on the device from a
given x_T.

`load_gligen_checkpoint` (:369) reads a GLIGEN .pth bundle (the UNet, the
VAE and the CLIP text encoder) into the three trees a `GligenPipeline`
takes, on the device it is given.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vitron_tpu_torch.models.diffusion import clip_text, samplers, unet2d, vae
from vitron_tpu_torch.models.diffusion.layers import position_net_with_image
from vitron_tpu_torch.models.diffusion.vae import SD_SCALE_FACTOR
from vitron_tpu_torch.models.llm.loader import load_torch_bundle
from vitron_tpu_torch.models.vision import vit


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

    def pooled_text_features(self, token_ids: torch.Tensor) -> torch.Tensor:
        """[N, 77] ids -> [N, hidden]: the final-LN hidden state at the EOS
        (argmax id) position, CLIP's pooler output."""
        hidden = clip_text.encode(self.text_params, self.cfg.text, token_ids)
        eos = token_ids.argmax(dim=-1)
        return hidden[torch.arange(hidden.shape[0], device=hidden.device), eos]

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
        pooled = self.pooled_text_features(phrase_ids)
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
        return _decode_uint8(self.vae_params, cfg.vae, x)


def reproject_image_feature(feature: torch.Tensor, projection_matrix: torch.Tensor) -> torch.Tensor:
    """GLIGEN's 'after_reproject' image-feature transform: through the
    learned matrix (transposed), L2-normalised, scaled to norm 28.7."""
    f = feature @ projection_matrix.T
    f = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-12)
    return f * 28.7


def _decode_uint8(vae_params, vcfg, x) -> torch.Tensor:
    img = vae.decode(vae_params, vcfg, x / SD_SCALE_FACTOR)[0]
    return ((img.clamp(-1, 1) * 0.5 + 0.5) * 255).to(torch.uint8)


class GligenStylePipeline(GligenPipeline):
    """Text + image grounded (style) generation. Needs a UNet whose
    `position_net` is the with-image one, the CLIP vision tower and its
    visual projection, and GLIGEN's projection matrix."""

    def __init__(self, cfg, unet_params, vae_params, text_params, vision_params=None,
                 vision_cfg=None, visual_proj=None, projection_matrix=None, tokenizer=None):
        super().__init__(cfg, unet_params, vae_params, text_params, tokenizer=tokenizer)
        self.vision_params = vision_params
        self.vision_cfg = vision_cfg
        self.visual_proj = visual_proj
        self.projection_matrix = projection_matrix

    def image_features(self, images: torch.Tensor) -> torch.Tensor:
        """[N, S, S, 3] preprocessed style crops -> [N, context_dim] grounding
        features: pooled CLIP image embeddings, reprojected and renormed."""
        pooled = vit.forward_pooled(self.vision_params, self.vision_cfg, images, self.visual_proj)
        if self.projection_matrix is not None:
            pooled = reproject_image_feature(pooled, self.projection_matrix)
        return pooled

    def prepare_styled(self, prompt: str, boxes: Sequence[Sequence[float]],
                       phrases: Sequence[str], style_images, has_text_mask: float = 1.0,
                       has_image_mask: float = 1.0, negative_prompt: str = "") -> Dict[str, Any]:
        """Host half of `generate_styled`: tokens, the packed boxes and slot
        masks, and for each slot i < len(boxes) the phrase and style image
        it takes, min(i, n - 1) of each (as `run_styled`'s keyword
        arguments, on the device)."""
        cfg = self.cfg
        dev = self.device
        mo = cfg.max_objs
        style = torch.as_tensor(style_images, dtype=torch.float32).to(dev)
        gb, gm, _ = pack_grounding(boxes, np.zeros((len(boxes), 1)), mo, 1)
        n = min(len(boxes), mo)
        phrase_slot = np.zeros((mo,), np.int64)
        image_slot = np.zeros((mo,), np.int64)
        phrase_slot[:n] = np.minimum(np.arange(n), len(phrases) - 1)
        image_slot[:n] = np.minimum(np.arange(n), style.shape[0] - 1)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

        return {"ids_ctx": t(self.tokenize([prompt]), torch.int64),
                "ids_uc": t(self.tokenize([negative_prompt]), torch.int64),
                "phrase_ids": t(self.tokenize(list(phrases)), torch.int64),
                "style_images": style, "gb": t(gb)[None], "gm": t(gm)[None],
                "tm": t(gm * np.float32(has_text_mask))[None],
                "im": t(gm * np.float32(has_image_mask))[None],
                "phrase_slot": t(phrase_slot, torch.int64),
                "image_slot": t(image_slot, torch.int64)}

    def grounding_tokens_styled(self, phrase_ids, style_images, gb, gm, tm, im, phrase_slot,
                                image_slot) -> torch.Tensor:
        """[1, 2 max_objs, context_dim]: the with-image PositionNet over each
        slot's pooled phrase feature and style feature (zero in empty slots)."""
        keep = gm[0][:, None]
        gt = self.pooled_text_features(phrase_ids)[phrase_slot] * keep
        gi = self.image_features(style_images)[image_slot] * keep
        return position_net_with_image(self.unet_params["position_net"], gb, gm, tm, im,
                                       gt.to(torch.float32)[None], gi.to(torch.float32)[None])

    def run_styled(self, ids_ctx, ids_uc, phrase_ids, style_images, gb, gm, tm, im, phrase_slot,
                   image_slot, x_t, steps: int, guidance_scale: float,
                   alpha_type: Tuple[float, ...]) -> torch.Tensor:
        """Device half of `generate_styled`: text and image features, the
        grounding tokens, PLMS from x_t [1, h, w, 4] with classifier-free
        guidance in one batched UNet call a step, VAE decode -> [H, W, 3]
        uint8."""
        cfg = self.cfg
        context = clip_text.encode(self.text_params, cfg.text, ids_ctx)
        uc = clip_text.encode(self.text_params, cfg.text, ids_uc)
        objs = self.grounding_tokens_styled(phrase_ids, style_images, gb, gm, tm, im,
                                            phrase_slot, image_slot)
        objs2 = torch.cat([objs, objs], dim=0)
        ctx2 = torch.cat([context, uc], dim=0)

        def eps(x, t, gate):
            tt = torch.full((2,), t, dtype=torch.int64, device=x.device)
            e_c, e_uc = unet2d.forward(self.unet_params, cfg.unet, torch.cat([x, x], dim=0), tt,
                                       ctx2, objs2, gate).chunk(2)
            return e_uc + guidance_scale * (e_c - e_uc)

        sched = samplers.DiffusionSchedule.create("linear", 1000, 0.00085, 0.012)
        gates = samplers.alpha_generator(steps, alpha_type)
        x = samplers.plms_sample(eps, x_t, sched, steps, gate_alphas=gates)
        return _decode_uint8(self.vae_params, cfg.vae, x)

    def generate_styled(self, prompt: str, boxes: Sequence[Sequence[float]],
                        phrases: Sequence[str], style_images, has_text_mask: float = 1.0,
                        has_image_mask: float = 1.0, negative_prompt: str = "",
                        guidance_scale: float = 7.5,
                        alpha_type: Sequence[float] = (0.3, 0.0, 0.7),
                        gen: Optional[torch.Generator] = None,
                        steps: Optional[int] = None) -> torch.Tensor:
        """-> [H, W, 3] uint8 image grounded on per-box phrases and style
        crops [N, S, S, 3] (preprocessed for the vision tower). `gen` (seed 0
        when None) draws x_T on the pipeline's device."""
        cfg = self.cfg
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        inputs = self.prepare_styled(prompt, boxes, phrases, style_images, has_text_mask,
                                     has_image_mask, negative_prompt)
        x_t = torch.randn((1, cfg.latent_size, cfg.latent_size, cfg.unet.out_channels),
                          generator=gen, device=self.device)
        return self.run_styled(**inputs, x_t=x_t, steps=steps or cfg.steps,
                               guidance_scale=float(guidance_scale),
                               alpha_type=tuple(alpha_type))


GLIGEN_BUNDLE_ENTRIES = ("model", "autoencoder", "text_encoder")


def load_gligen_checkpoint(path, cfg: GligenConfig, inpaint: bool = False, device="cpu"):
    """A GLIGEN .pth bundle (the reference's load_ckpt: a dict of the 'model'
    (UNet), 'autoencoder' and 'text_encoder' state dicts, with an OmegaConf
    'config' pickled beside them) -> (unet_params, vae_params, text_params)
    on `device`, converted tensor by tensor there.

    The bundle is read without importing the config's classes
    (`loader.load_torch_bundle`); a bundle without one of the three state
    dicts raises. Pass inpaint=True for the 9-channel inpainting checkpoint:
    the UNet is read at `cfg.unet` with 9 input channels."""
    bundle = load_torch_bundle(path)
    missing = [k for k in GLIGEN_BUNDLE_ENTRIES if k not in bundle]
    if missing:
        raise KeyError(f"{path}: not a GLIGEN bundle, it lacks {missing} "
                       f"(it holds {sorted(bundle)})")
    ucfg = dataclasses.replace(cfg.unet, in_channels=9) if inpaint else cfg.unet
    return (unet2d.convert_ldm_unet(bundle["model"], ucfg, device=device),
            vae.convert_ldm_vae(bundle["autoencoder"], cfg.vae, device=device),
            clip_text.convert_hf_clip_text(bundle["text_encoder"], cfg.text, device=device))
