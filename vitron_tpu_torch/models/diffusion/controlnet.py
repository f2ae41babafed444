"""ControlNet: a hint-conditioned copy of the SD UNet encoder with zero convs.

Port of `vitron_tpu/models/diffusion/controlnet.py` (the StableVideo
ControlNet, reference cldm.py:22-305): the input-hint conv stack
(3 -> 16 -> 16 -> 32 -> 32 -> 96 -> 96 -> 256 -> model_channels, three
stride-2 stages), a trainable copy of the UNet encoder emitting one
zero-conv'ed residual per input block plus a middle residual, and the
controlled UNet whose decoder adds the residuals to its skips. Both halves
walk the port's `unet2d` block plan (`_run_block`), so they run B2 (flash
at >= VITRON_FLASH_MIN tokens), B3 (GEGLU) and B8 (group-norm sums) at the
UNet's sites. The checkpoint converter (`convert_torch`) waits for the
loaders (ROADMAP A7).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from vitron_tpu_torch.models.diffusion import unet2d
from vitron_tpu_torch.models.diffusion.layers import conv2d, group_norm, timestep_embedding
from vitron_tpu_torch.models.diffusion.unet2d import UNetConfig, block_plan

HINT_CHANNELS = (16, 16, 32, 32, 96, 96, 256)
HINT_STRIDES = (1, 1, 2, 1, 2, 1, 2)


def block_channels(cfg: UNetConfig) -> List[int]:
    """The channels of each input block's output (its zero conv's width)."""
    out, ch = [], cfg.model_channels
    for entries in block_plan(cfg)[0]:
        for e in entries:
            if e[0] in ("conv_in", "res"):
                ch = e[2]
        out.append(ch)
    return out


def init_params(gen: torch.Generator, cfg: UNetConfig, device) -> Dict[str, Any]:
    """ControlNet params: a UNet encoder copy, the hint block and the zero
    convs (the JAX init's scales and zero leaves; `gen` lives on `device`)."""
    base = unet2d.init_params(gen, cfg, device, grounding=False)
    f32 = torch.float32

    def conv(cin, cout, zero=False):
        if zero:
            return torch.zeros((3, 3, cin, cout), dtype=f32, device=device)
        w = torch.randn((3, 3, cin, cout), generator=gen, dtype=f32, device=device)
        return w / math.sqrt(9 * cin)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    hint, cin = [], 3
    for cout in HINT_CHANNELS:
        hint.append({"w": conv(cin, cout), "b": zeros(cout)})
        cin = cout
    hint.append({"w": conv(cin, cfg.model_channels, zero=True), "b": zeros(cfg.model_channels)})
    chans = block_channels(cfg)
    return {
        "time_w1": base["time_w1"], "time_b1": base["time_b1"],
        "time_w2": base["time_w2"], "time_b2": base["time_b2"],
        "input_blocks": base["input_blocks"],
        "middle_block": base["middle_block"],
        "hint_block": hint,
        "zero_convs": [{"w": zeros(1, 1, c, c), "b": zeros(c)} for c in chans],
        "middle_out": {"w": zeros(1, 1, chans[-1], chans[-1]), "b": zeros(chans[-1])},
    }


def _time_embedding(params, cfg: UNetConfig, timesteps: torch.Tensor) -> torch.Tensor:
    t_emb = timestep_embedding(timesteps, cfg.model_channels)
    emb = F.silu(t_emb @ params["time_w1"].float() + params["time_b1"].float())
    return emb @ params["time_w2"].float() + params["time_b2"].float()


def hint_features(params, hint: torch.Tensor) -> torch.Tensor:
    """hint [B, H, W, 3] in [0, 1] -> [B, H/8, W/8, model_channels]."""
    h = hint
    for p, stride in zip(params["hint_block"][:-1], HINT_STRIDES):
        h = F.silu(conv2d(h, p["w"], p["b"], stride=stride, padding=1))
    last = params["hint_block"][-1]
    return conv2d(h, last["w"], last["b"], padding=1)


def control_residuals(params, cfg: UNetConfig, x: torch.Tensor, hint: torch.Tensor,
                      timesteps: torch.Tensor, context: torch.Tensor) -> List[torch.Tensor]:
    """The control encoder -> one residual per input block, then the
    middle's (cldm.py:283-305)."""
    emb = _time_embedding(params, cfg, timesteps)
    guided = hint_features(params, hint)
    input_plan, middle_plan, _ = block_plan(cfg)
    outs = []
    h = x
    for bi, (entries, layers) in enumerate(zip(input_plan, params["input_blocks"])):
        h = unet2d._run_block(entries, layers, h, emb, context, None, cfg, 1.0)
        if bi == 0:
            h = h + guided
        zc = params["zero_convs"][bi]
        outs.append(conv2d(h, zc["w"], zc["b"]))
    h = unet2d._run_block(middle_plan, params["middle_block"], h, emb, context, None, cfg, 1.0)
    mo = params["middle_out"]
    outs.append(conv2d(h, mo["w"], mo["b"]))
    return outs


def controlled_forward(unet_params, cfg: UNetConfig, x: torch.Tensor, timesteps: torch.Tensor,
                       context: torch.Tensor, control: List[torch.Tensor],
                       control_scale: float = 1.0) -> torch.Tensor:
    """The UNet forward with the control residuals added to the middle and
    the skips (cldm.py:23-45)."""
    emb = _time_embedding(unet_params, cfg, timesteps)
    input_plan, middle_plan, output_plan = block_plan(cfg)
    control = [c * control_scale for c in control]
    hs = []
    h = x
    for entries, layers in zip(input_plan, unet_params["input_blocks"]):
        h = unet2d._run_block(entries, layers, h, emb, context, None, cfg, 1.0)
        hs.append(h)
    h = unet2d._run_block(middle_plan, unet_params["middle_block"], h, emb, context, None, cfg,
                          1.0)
    h = h + control[-1]
    skips = control[:-1]
    for entries, layers in zip(output_plan, unet_params["output_blocks"]):
        h = torch.cat([h, hs.pop() + skips.pop()], dim=-1)
        h = unet2d._run_block(entries, layers, h, emb, context, None, cfg, 1.0)
    h = group_norm(h, unet_params["out_norm_s"], unet_params["out_norm_b"])
    return conv2d(F.silu(h), unet_params["out_w"], unet_params["out_b"], padding=1)
