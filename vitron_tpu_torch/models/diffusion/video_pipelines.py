"""Text-to-video: the ZeroScope / T2V pipeline (task D).

Port of the text-to-video half of
`vitron_tpu/models/diffusion/video_pipelines.py` (:28-145): CLIP text
encoding of [prompt, negative prompt], v-prediction DDIM over the cosine
zero-terminal-SNR schedule with classifier-free guidance (one UNet call of
batch 2 per step), and the SD VAE decode of every frame to uint8
[T, H, W, 3]. Weights are resident on one device.

`generate` = `tokenize` (the host half), the initial latent x_T
[1, T, h, w, 4] drawn from an explicit `torch.Generator`, then `run` (the
device half), which takes x_T as an input: a caller can hand it the x_T that
the JAX `run` body draws. `Image2VideoPipeline` (task G), the W8A8 UNet
(`VITRON_VUNET_QUANT`, A17) and the checkpoint loaders (A7) wait (ROADMAP
A11).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from vitron_tpu_torch.models.diffusion import clip_text, samplers, unet_sd_video, vae
from vitron_tpu_torch.models.diffusion.vae import SD_SCALE_FACTOR


def _schedule(cfg_unet) -> samplers.DiffusionSchedule:
    # the DiffusionDDIM schedule of the i2vgen / t2v configs
    return samplers.DiffusionSchedule.create("cosine", 1000, zero_terminal_snr=True)


@dataclasses.dataclass(frozen=True)
class Text2VideoConfig:
    unet: unet_sd_video.UNetSDVideoConfig = dataclasses.field(
        default_factory=unet_sd_video.UNetSDVideoConfig.t2v)
    vae: vae.VAEConfig = dataclasses.field(default_factory=vae.VAEConfig.sd)
    text: clip_text.TextConfig = dataclasses.field(
        default_factory=lambda: clip_text.TextConfig.clip_l(hidden_size=1024, num_heads=16))
    height: int = 320
    width: int = 576
    num_frames: int = 24
    steps: int = 50
    guidance_scale: float = 9.0

    @staticmethod
    def tiny(**kw) -> "Text2VideoConfig":
        base = dict(
            unet=unet_sd_video.UNetSDVideoConfig.tiny("t2v", context_dim=16, y_dim=16),
            vae=vae.VAEConfig.tiny(),
            text=clip_text.TextConfig.tiny(hidden_size=16, num_heads=2, intermediate_size=32),
            height=16, width=16, num_frames=4, steps=4, guidance_scale=7.0)
        base.update(kw)
        return Text2VideoConfig(**base)

    @property
    def latent_hw(self):
        f = 2 ** (len(self.vae.channel_mult) - 1)
        return self.height // f, self.width // f


class Text2VideoPipeline:
    """prompt -> [T, H, W, 3] uint8 frames (UNetSD_T2VBase / ZeroScope)."""

    def __init__(self, cfg: Text2VideoConfig, unet_params, vae_params, text_params,
                 tokenizer=None):
        self.cfg = cfg
        self.unet_params = unet_params
        self.vae_params = vae_params
        self.text_params = text_params
        self.tokenizer = tokenizer
        self.device = text_params["token_emb"].device

    def tokenize(self, texts: List[str]) -> torch.Tensor:
        """Host half: token ids [len(texts), max_length] on the device."""
        tok = self.tokenizer(texts, padding="max_length", max_length=self.cfg.text.max_length,
                             truncation=True, return_tensors="np")
        return torch.as_tensor(np.asarray(tok["input_ids"]), dtype=torch.int64,
                               device=self.device)

    def generate(self, prompt: str, negative_prompt: str = "",
                 gen: Optional[torch.Generator] = None,
                 steps: Optional[int] = None) -> torch.Tensor:
        """-> [T, H, W, 3] uint8 frames on the pipeline's device. `gen` (a
        generator on that device; seed 0 when None) draws x_T."""
        cfg = self.cfg
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        ids = self.tokenize([prompt, negative_prompt])
        lh, lw = cfg.latent_hw
        x_t = torch.randn((1, cfg.num_frames, lh, lw, cfg.unet.in_dim), generator=gen,
                          device=self.device)
        return self.run(ids, x_t, steps or cfg.steps)

    def v_fn(self, ctx2: torch.Tensor):
        """The guided v-prediction of one step: the UNet on the batch
        [x, x] with contexts [prompt, negative], then v_uc + s (v_c - v_uc)."""
        cfg = self.cfg
        gs = cfg.guidance_scale

        def v(x, t):
            xx = torch.cat([x, x], dim=0)
            tt = torch.full((2,), float(t), dtype=torch.float32, device=x.device)
            v_c, v_uc = unet_sd_video.forward(self.unet_params, cfg.unet, xx, tt,
                                              y=ctx2).chunk(2)
            return v_uc + gs * (v_c - v_uc)

        return v

    def run(self, ids: torch.Tensor, x_t: torch.Tensor, steps: int) -> torch.Tensor:
        """Device half of `generate`: ids [2, L] (prompt, negative), x_t
        [1, T, h, w, 4] -> [T, H, W, 3] uint8."""
        cfg = self.cfg
        ctx2 = clip_text.encode(self.text_params, cfg.text, ids)
        x = samplers.ddim_sample_v(self.v_fn(ctx2), x_t, _schedule(cfg.unet), steps)
        frames = vae.decode(self.vae_params, cfg.vae, x[0] / SD_SCALE_FACTOR)
        frames = frames.clamp(-1, 1) * 0.5 + 0.5
        return (frames * 255).to(torch.uint8)
