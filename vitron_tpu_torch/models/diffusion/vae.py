"""AutoencoderKL (SD VAE) encoder and decoder.

Port of `vitron_tpu/models/diffusion/vae.py`, NHWC throughout. The
single-head mid attention goes through `layers._mha`, which sends it to the
flash kernel at D = 512 on CUDA once it has >= 1024 tokens (64x64 latents
at 512^2). `convert_ldm_vae` (:212) reads an ldm AutoencoderKL state dict
into the param tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from vitron_tpu_torch.models.diffusion.layers import (_mha, conv2d, conv_w, group_norm, reading,
                                                      upsample2x_nearest)

SD_SCALE_FACTOR = 0.18215


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4

    @staticmethod
    def sd(**kw) -> "VAEConfig":
        return VAEConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "VAEConfig":
        base = dict(base_channels=32, channel_mult=(1, 2), num_res_blocks=1, z_channels=4)
        base.update(kw)
        return VAEConfig(**base)


def _resnet(p, x):
    h = group_norm(x, p["norm1_s"], p["norm1_b"])
    h = conv2d(F.silu(h), p["conv1_w"], p["conv1_b"], padding=1)
    h = group_norm(h, p["norm2_s"], p["norm2_b"])
    h = conv2d(F.silu(h), p["conv2_w"], p["conv2_b"], padding=1)
    if "nin_w" in p:
        x = conv2d(x, p["nin_w"], p["nin_b"])
    return x + h


def _attn(p, x):
    b, h, w, c = x.shape
    hn = group_norm(x, p["norm_s"], p["norm_b"])
    q = conv2d(hn, p["q_w"], p["q_b"]).reshape(b, h * w, c)
    k = conv2d(hn, p["k_w"], p["k_b"]).reshape(b, h * w, c)
    v = conv2d(hn, p["v_w"], p["v_b"]).reshape(b, h * w, c)
    o = _mha(q, k, v, heads=1, scale=c ** -0.5).reshape(b, h, w, c)
    return x + conv2d(o, p["proj_w"], p["proj_b"])


def encode(params: Dict[str, Any], cfg: VAEConfig, x: torch.Tensor):
    """x [B, H, W, 3] in [-1, 1] -> (mean, logvar), each [B, H/8, W/8, z]."""
    e = params["encoder"]
    h = conv2d(x, e["conv_in_w"], e["conv_in_b"], padding=1)
    for level in e["down"]:
        for blk in level["blocks"]:
            h = _resnet(blk, h)
        if "down_w" in level:
            # ldm pads (0, 1, 0, 1), then a stride-2 conv with no padding
            h = F.pad(h, (0, 0, 0, 1, 0, 1))
            h = conv2d(h, level["down_w"], level["down_b"], stride=2, padding=0)
    h = _resnet(e["mid1"], h)
    h = _attn(e["mid_attn"], h)
    h = _resnet(e["mid2"], h)
    h = group_norm(h, e["out_norm_s"], e["out_norm_b"])
    h = conv2d(F.silu(h), e["conv_out_w"], e["conv_out_b"], padding=1)
    moments = conv2d(h, params["quant_w"], params["quant_b"])
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def sample_latent(mean: torch.Tensor, logvar: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """A draw from the posterior N(mean, exp(logvar)), given the standard
    normal `noise` of mean's shape (what the JAX package draws from its rng)."""
    return mean + torch.exp(0.5 * logvar) * noise


def decode(params: Dict[str, Any], cfg: VAEConfig, z: torch.Tensor) -> torch.Tensor:
    """z [B, h, w, z_channels] -> image [B, 8h, 8w, 3] in [-1, 1]."""
    d = params["decoder"]
    h = conv2d(z, params["post_quant_w"], params["post_quant_b"])
    h = conv2d(h, d["conv_in_w"], d["conv_in_b"], padding=1)
    h = _resnet(d["mid1"], h)
    h = _attn(d["mid_attn"], h)
    h = _resnet(d["mid2"], h)
    for level in d["up"]:
        for blk in level["blocks"]:
            h = _resnet(blk, h)
        if "up_w" in level:
            h = conv2d(upsample2x_nearest(h), level["up_w"], level["up_b"], padding=1)
    h = group_norm(h, d["out_norm_s"], d["out_norm_b"])
    return conv2d(F.silu(h), d["conv_out_w"], d["conv_out_b"], padding=1)


# ---------------------------------------------------------------- init


def init_params(gen: torch.Generator, cfg: VAEConfig, device) -> Dict[str, Any]:
    """Random float32 params with the JAX init's scales (N(0, 1/fan_in)
    convs, zero biases, unit norms)."""
    f32 = torch.float32
    bc = cfg.base_channels

    def cw(ci, co, kk=3):
        w = torch.randn((kk, kk, ci, co), generator=gen, dtype=f32, device=device)
        return w / math.sqrt(kk * kk * ci)

    def zeros(n):
        return torch.zeros((n,), dtype=f32, device=device)

    def ones(n):
        return torch.ones((n,), dtype=f32, device=device)

    def resnet(cin, cout):
        p = {"norm1_s": ones(cin), "norm1_b": zeros(cin),
             "conv1_w": cw(cin, cout), "conv1_b": zeros(cout),
             "norm2_s": ones(cout), "norm2_b": zeros(cout),
             "conv2_w": cw(cout, cout), "conv2_b": zeros(cout)}
        if cin != cout:
            p["nin_w"] = cw(cin, cout, 1)
            p["nin_b"] = zeros(cout)
        return p

    def attn(c):
        return {"norm_s": ones(c), "norm_b": zeros(c),
                "q_w": cw(c, c, 1), "q_b": zeros(c), "k_w": cw(c, c, 1), "k_b": zeros(c),
                "v_w": cw(c, c, 1), "v_b": zeros(c), "proj_w": cw(c, c, 1),
                "proj_b": zeros(c)}

    ch = bc
    down = []
    for li, mult in enumerate(cfg.channel_mult):
        blocks = []
        for _ in range(cfg.num_res_blocks):
            blocks.append(resnet(ch, mult * bc))
            ch = mult * bc
        level = {"blocks": blocks}
        if li != len(cfg.channel_mult) - 1:
            level["down_w"] = cw(ch, ch)
            level["down_b"] = zeros(ch)
        down.append(level)
    encoder = {"conv_in_w": cw(cfg.in_channels, bc), "conv_in_b": zeros(bc), "down": down,
               "mid1": resnet(ch, ch), "mid_attn": attn(ch), "mid2": resnet(ch, ch),
               "out_norm_s": ones(ch), "out_norm_b": zeros(ch),
               "conv_out_w": cw(ch, 2 * cfg.z_channels),
               "conv_out_b": zeros(2 * cfg.z_channels)}
    top = cfg.channel_mult[-1] * bc
    dch = top
    up = []
    for li, mult in list(enumerate(cfg.channel_mult))[::-1]:
        blocks = []
        for _ in range(cfg.num_res_blocks + 1):
            blocks.append(resnet(dch, mult * bc))
            dch = mult * bc
        level = {"blocks": blocks}
        if li != 0:
            level["up_w"] = cw(dch, dch)
            level["up_b"] = zeros(dch)
        up.append(level)
    decoder = {"conv_in_w": cw(cfg.z_channels, top), "conv_in_b": zeros(top),
               "mid1": resnet(top, top), "mid_attn": attn(top), "mid2": resnet(top, top),
               "up": up, "out_norm_s": ones(bc), "out_norm_b": zeros(bc),
               "conv_out_w": cw(bc, cfg.in_channels), "conv_out_b": zeros(cfg.in_channels)}
    z2 = 2 * cfg.z_channels
    return {"encoder": encoder, "decoder": decoder,
            "quant_w": cw(z2, z2, 1), "quant_b": zeros(z2),
            "post_quant_w": cw(cfg.z_channels, cfg.z_channels, 1),
            "post_quant_b": zeros(cfg.z_channels)}


# ---------------------------------------------------------------- convert


def convert_ldm_vae(sd, cfg: VAEConfig, prefix: str = "", device="cpu") -> Dict[str, Any]:
    """ldm AutoencoderKL state dict -> param tree on `device`. Handles
    'first_stage_model.' or bare prefixes."""
    if not prefix and any(k.startswith("first_stage_model.") for k in sd):
        prefix = "first_stage_model."
    sd = reading(sd, device)

    def g(k):
        return sd[prefix + k]

    def cv(k):
        return conv_w(sd, prefix + k)

    def resnet(b):
        p = {
            "norm1_s": g(b + "norm1.weight"), "norm1_b": g(b + "norm1.bias"),
            "conv1_w": cv(b + "conv1.weight"), "conv1_b": g(b + "conv1.bias"),
            "norm2_s": g(b + "norm2.weight"), "norm2_b": g(b + "norm2.bias"),
            "conv2_w": cv(b + "conv2.weight"), "conv2_b": g(b + "conv2.bias"),
        }
        if (prefix + b + "nin_shortcut.weight") in sd:
            p["nin_w"] = cv(b + "nin_shortcut.weight")
            p["nin_b"] = g(b + "nin_shortcut.bias")
        return p

    def attn(b):
        return {
            "norm_s": g(b + "norm.weight"), "norm_b": g(b + "norm.bias"),
            "q_w": cv(b + "q.weight"), "q_b": g(b + "q.bias"),
            "k_w": cv(b + "k.weight"), "k_b": g(b + "k.bias"),
            "v_w": cv(b + "v.weight"), "v_b": g(b + "v.bias"),
            "proj_w": cv(b + "proj_out.weight"), "proj_b": g(b + "proj_out.bias"),
        }

    n_levels = len(cfg.channel_mult)
    down = []
    for li in range(n_levels):
        level = {"blocks": [resnet(f"encoder.down.{li}.block.{bi}.")
                            for bi in range(cfg.num_res_blocks)]}
        if (prefix + f"encoder.down.{li}.downsample.conv.weight") in sd:
            level["down_w"] = cv(f"encoder.down.{li}.downsample.conv.weight")
            level["down_b"] = g(f"encoder.down.{li}.downsample.conv.bias")
        down.append(level)
    up = []
    for li in range(n_levels - 1, -1, -1):  # the decoder walks the levels top-down
        level = {"blocks": [resnet(f"decoder.up.{li}.block.{bi}.")
                            for bi in range(cfg.num_res_blocks + 1)]}
        if (prefix + f"decoder.up.{li}.upsample.conv.weight") in sd:
            level["up_w"] = cv(f"decoder.up.{li}.upsample.conv.weight")
            level["up_b"] = g(f"decoder.up.{li}.upsample.conv.bias")
        up.append(level)
    return {
        "encoder": {
            "conv_in_w": cv("encoder.conv_in.weight"), "conv_in_b": g("encoder.conv_in.bias"),
            "down": down,
            "mid1": resnet("encoder.mid.block_1."),
            "mid_attn": attn("encoder.mid.attn_1."),
            "mid2": resnet("encoder.mid.block_2."),
            "out_norm_s": g("encoder.norm_out.weight"), "out_norm_b": g("encoder.norm_out.bias"),
            "conv_out_w": cv("encoder.conv_out.weight"), "conv_out_b": g("encoder.conv_out.bias"),
        },
        "decoder": {
            "conv_in_w": cv("decoder.conv_in.weight"), "conv_in_b": g("decoder.conv_in.bias"),
            "mid1": resnet("decoder.mid.block_1."),
            "mid_attn": attn("decoder.mid.attn_1."),
            "mid2": resnet("decoder.mid.block_2."),
            "up": up,
            "out_norm_s": g("decoder.norm_out.weight"), "out_norm_b": g("decoder.norm_out.bias"),
            "conv_out_w": cv("decoder.conv_out.weight"), "conv_out_b": g("decoder.conv_out.bias"),
        },
        "quant_w": cv("quant_conv.weight"), "quant_b": g("quant_conv.bias"),
        "post_quant_w": cv("post_quant_conv.weight"), "post_quant_b": g("post_quant_conv.bias"),
    }
