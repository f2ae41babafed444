"""Text-to-video (ZeroScope / T2V, task D) and image-to-video (I2VGen-XL,
task G) pipelines.

Port of `vitron_tpu/models/diffusion/video_pipelines.py` (:28-263): CLIP
text encoding of [prompt, negative prompt], v-prediction DDIM over the
cosine zero-terminal-SNR schedule with classifier-free guidance (one UNet
call of batch 2 per step), and the SD VAE decode of every frame to uint8
[T, H, W, 3]. Weights are resident on one device.

Each pipeline's `generate` = a host half (tokenize; for I2V also the image
embedder and the resize of the request image), the initial latent x_T
[1, T, h, w, 4] drawn from an explicit `torch.Generator`, then `run` (the
device half), which takes x_T as an input: a caller can hand it the x_T that
the JAX `run` body draws. I2V's `run` also VAE-encodes the image: its
latent feeds the UNet's first-frame concat and local-context streams, the
image embedding its global tokens.

Two faults of the reference are fixed here: `generate` raises `ValueError`
for a step count that does not divide the schedule's 1000 steps (the
sampler would run one more step, from alpha 0, and give NaN; ROADMAP C6),
and I2V resizes a request image of any size to `cfg.size` square on the
host (the JAX pipeline fails on a non-square one; C7). The pipelines take
param trees: `unet_sd_video.convert_torch`, `vae.convert_ldm_vae` and
`clip_text.convert_hf_clip_text` read them from checkpoint state dicts.
Under `VITRON_VUNET_QUANT=w8a8` both constructors quantize their UNet's
convs (`unet_sd_video.quantize_params`), as JAX's do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from vitron_tpu_torch.media.preprocess import _resize_hw
from vitron_tpu_torch.models.diffusion import clip_text, samplers, unet_sd_video, vae
from vitron_tpu_torch.models.diffusion.vae import SD_SCALE_FACTOR


def _schedule(cfg_unet) -> samplers.DiffusionSchedule:
    # the DiffusionDDIM schedule of the i2vgen / t2v configs
    return samplers.DiffusionSchedule.create("cosine", 1000, zero_terminal_snr=True)


def _check_steps(cfg_unet, steps: int) -> None:
    """C6: only a divisor of the schedule's length gives `steps` DDIM steps."""
    n = _schedule(cfg_unet).num_timesteps
    if steps <= 0 or n % steps:
        raise ValueError(f"{steps} DDIM steps: the step count must divide the schedule's {n} "
                         "(another count starts at alpha 0 and gives NaN)")


def _tokenize(tokenizer, cfg_text, texts: List[str], device) -> torch.Tensor:
    tok = tokenizer(texts, padding="max_length", max_length=cfg_text.max_length,
                    truncation=True, return_tensors="np")
    return torch.as_tensor(np.asarray(tok["input_ids"]), dtype=torch.int64, device=device)


def _decode_frames(vae_params, cfg_vae, x: torch.Tensor) -> torch.Tensor:
    """The sampled latent [1, T, h, w, 4] -> [T, H, W, 3] uint8."""
    frames = vae.decode(vae_params, cfg_vae, x[0] / SD_SCALE_FACTOR)
    return ((frames.clamp(-1, 1) * 0.5 + 0.5) * 255).to(torch.uint8)


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
        if unet_sd_video.quant_default():  # VITRON_VUNET_QUANT=w8a8: the convs on Q2
            unet_params = unet_sd_video.quantize_params(unet_params)
        self.unet_params = unet_params
        self.vae_params = vae_params
        self.text_params = text_params
        self.tokenizer = tokenizer
        self.device = text_params["token_emb"].device

    def tokenize(self, texts: List[str]) -> torch.Tensor:
        """Host half: token ids [len(texts), max_length] on the device."""
        return _tokenize(self.tokenizer, self.cfg.text, texts, self.device)

    def generate(self, prompt: str, negative_prompt: str = "",
                 gen: Optional[torch.Generator] = None,
                 steps: Optional[int] = None) -> torch.Tensor:
        """-> [T, H, W, 3] uint8 frames on the pipeline's device. `gen` (a
        generator on that device; seed 0 when None) draws x_T. `steps`
        must divide 1000 (C6)."""
        cfg = self.cfg
        steps = steps or cfg.steps
        _check_steps(cfg.unet, steps)
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        ids = self.tokenize([prompt, negative_prompt])
        lh, lw = cfg.latent_hw
        x_t = torch.randn((1, cfg.num_frames, lh, lw, cfg.unet.in_dim), generator=gen,
                          device=self.device)
        return self.run(ids, x_t, steps)

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
        return _decode_frames(self.vae_params, cfg.vae, x)


@dataclasses.dataclass(frozen=True)
class Image2VideoConfig:
    unet: unet_sd_video.UNetSDVideoConfig = dataclasses.field(
        default_factory=unet_sd_video.UNetSDVideoConfig.i2vgen_xl)
    vae: vae.VAEConfig = dataclasses.field(default_factory=vae.VAEConfig.sd)
    text: clip_text.TextConfig = dataclasses.field(
        default_factory=lambda: clip_text.TextConfig.clip_l(hidden_size=1024, num_heads=16))
    size: int = 512
    num_frames: int = 16
    fps: int = 16                 # the FPS condition (i2vgen_xl_infer.yaml:8)
    steps: int = 50
    guidance_scale: float = 9.0

    @staticmethod
    def tiny(**kw) -> "Image2VideoConfig":
        base = dict(
            unet=unet_sd_video.UNetSDVideoConfig.tiny("i2vgen", context_dim=16, y_dim=16),
            vae=vae.VAEConfig.tiny(),
            text=clip_text.TextConfig.tiny(hidden_size=16, num_heads=2, intermediate_size=32),
            size=16, num_frames=4, steps=4, guidance_scale=7.0)
        base.update(kw)
        return Image2VideoConfig(**base)

    @property
    def latent_size(self):
        return self.size // (2 ** (len(self.vae.channel_mult) - 1))


class Image2VideoPipeline:
    """image (+ prompt) -> [T, size, size, 3] uint8 frames (UNetSD_I2VGen).

    `image_embedder(image_uint8) -> [1, y_dim]` gives the global image
    embedding (upstream's OpenCLIP visual tower,
    inference_i2vgen_entrance.py:195); without one the embedding is zeros,
    as in JAX (ROADMAP C4)."""

    def __init__(self, cfg: Image2VideoConfig, unet_params, vae_params, text_params,
                 tokenizer=None, image_embedder: Optional[Callable] = None):
        self.cfg = cfg
        if unet_sd_video.quant_default():
            unet_params = unet_sd_video.quantize_params(unet_params)
        self.unet_params = unet_params
        self.vae_params = vae_params
        self.text_params = text_params
        self.tokenizer = tokenizer
        self.image_embedder = image_embedder
        self.device = text_params["token_emb"].device

    def prepare(self, image, prompt: str, negative_prompt: str = ""):
        """Host half: (ids [2, L], image [size, size, 3] uint8, global
        embedding [1, y_dim] float32), all on the device. The embedder sees
        the request image as it came; the image is resized to `cfg.size`
        square (antialiased linear, rounded) when it is not that already (C7)."""
        cfg = self.cfg
        ids = _tokenize(self.tokenizer, cfg.text, [prompt, negative_prompt], self.device)
        img = np.asarray(image)
        if self.image_embedder is not None:
            glob = torch.as_tensor(self.image_embedder(img), dtype=torch.float32)
        else:
            glob = torch.zeros((1, cfg.unet.y_dim), dtype=torch.float32)
        pixels = torch.as_tensor(img)
        if tuple(pixels.shape[:2]) != (cfg.size, cfg.size):
            pixels = _resize_hw(pixels.to(torch.float32), cfg.size, cfg.size, "linear")
            pixels = pixels.round().clamp(0, 255).to(torch.uint8)
        return ids, pixels.to(self.device), glob.to(self.device)

    def generate(self, image, prompt: str, negative_prompt: str = "",
                 gen: Optional[torch.Generator] = None,
                 steps: Optional[int] = None) -> torch.Tensor:
        """image [H, W, 3] uint8 -> [T, size, size, 3] uint8 frames on the
        pipeline's device. `gen` (a generator on that device; seed 8800,
        the reference's fixed seed, when None) draws x_T; `steps` must
        divide 1000 (C6)."""
        cfg = self.cfg
        steps = steps or cfg.steps
        _check_steps(cfg.unet, steps)
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(8800)  # app.py:332
        ids, pixels, glob = self.prepare(image, prompt, negative_prompt)
        ls = cfg.latent_size
        x_t = torch.randn((1, cfg.num_frames, ls, ls, cfg.unet.in_dim), generator=gen,
                          device=self.device)
        return self.run(ids, pixels, glob, x_t, steps)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        """[size, size, 3] uint8 -> the first-frame latent [1, h, w, 4]:
        the VAE encoder's mean, scaled."""
        img = (pixels.to(torch.float32) / 255.0 - 0.5) / 0.5
        mean, _ = vae.encode(self.vae_params, self.cfg.vae, img[None])
        return mean * SD_SCALE_FACTOR

    def v_fn(self, ctx2: torch.Tensor, local: torch.Tensor, glob: torch.Tensor):
        """The guided v-prediction of one step: the UNet on [x, x] with
        contexts [prompt, negative], local latents [local, local], global
        embeddings [glob, 0] and fps 16, then v_uc + s (v_c - v_uc)."""
        cfg = self.cfg
        gs = cfg.guidance_scale
        local2 = torch.cat([local, local], dim=0)
        glob2 = torch.cat([glob, torch.zeros_like(glob)], dim=0)
        fps2 = torch.full((2,), float(cfg.fps), dtype=torch.float32, device=local.device)

        def v(x, t):
            xx = torch.cat([x, x], dim=0)
            tt = torch.full((2,), float(t), dtype=torch.float32, device=x.device)
            v_c, v_uc = unet_sd_video.forward(self.unet_params, cfg.unet, xx, tt, y=ctx2,
                                              fps=fps2, image=glob2,
                                              local_image=local2).chunk(2)
            return v_uc + gs * (v_c - v_uc)

        return v

    def run(self, ids: torch.Tensor, pixels: torch.Tensor, glob: torch.Tensor,
            x_t: torch.Tensor, steps: int) -> torch.Tensor:
        """Device half of `generate`: ids [2, L] (prompt, negative), pixels
        [size, size, 3] uint8, glob [1, y_dim], x_t [1, T, h, w, 4] ->
        [T, size, size, 3] uint8."""
        cfg = self.cfg
        ctx2 = clip_text.encode(self.text_params, cfg.text, ids)
        v = self.v_fn(ctx2, self.encode_image(pixels), glob)
        x = samplers.ddim_sample_v(v, x_t, _schedule(cfg.unet), steps)
        return _decode_frames(self.vae_params, cfg.vae, x)
