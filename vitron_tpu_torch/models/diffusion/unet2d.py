"""SD v1.4 UNet with GLIGEN grounding (gated self-attention fuser).

Port of `vitron_tpu/models/diffusion/unet2d.py`: NHWC activations, the
same param tree and the same static block plan (`block_plan`), so the
forward walks the blocks exactly as the JAX one unrolls them. One UNet
serves GLIGEN generation (4 input channels), inpainting (9) and plain SD
(no fuser params). `convert_ldm_unet` (:338) reads an ldm / GLIGEN state
dict into that tree; `quantize_params` (W8A8) waits for ROADMAP A17.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vitron_tpu_torch.models.diffusion.layers import (
    conv2d,
    conv_w,
    convert_position_net,
    convert_spatial_transformer,
    group_norm,
    lin_w,
    position_net,
    reading,
    spatial_transformer,
    timestep_embedding,
    upsample2x_nearest,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4              # 9 for GLIGEN inpainting (latent + masked latent + mask)
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8
    context_dim: int = 768
    transformer_depth: int = 1

    @staticmethod
    def sd_v1(**kw) -> "UNetConfig":
        return UNetConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "UNetConfig":
        base = dict(model_channels=32, num_res_blocks=1, attention_resolutions=(2, 1),
                    channel_mult=(1, 2), num_heads=2, context_dim=16, transformer_depth=1)
        base.update(kw)
        return UNetConfig(**base)


def block_plan(cfg: UNetConfig):
    """ldm's input/middle/output block layout as lists of ('conv_in', cin,
    cout) / ('res', cin, cout) / ('attn', ch) / ('down', ch) / ('up', ch)."""
    mc = cfg.model_channels
    input_plan: List[List[tuple]] = [[("conv_in", cfg.in_channels, mc)]]
    skips = [mc]
    ch = mc
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            block = [("res", ch, mult * mc)]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                block.append(("attn", ch))
            input_plan.append(block)
            skips.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_plan.append([("down", ch)])
            skips.append(ch)
            ds *= 2
    middle_plan = [("res", ch, ch), ("attn", ch), ("res", ch, ch)]
    output_plan: List[List[tuple]] = []
    for level, mult in list(enumerate(cfg.channel_mult))[::-1]:
        for i in range(cfg.num_res_blocks + 1):
            ich = skips.pop()
            block = [("res", ch + ich, mult * mc)]
            ch = mult * mc
            if ds in cfg.attention_resolutions:
                block.append(("attn", ch))
            if level and i == cfg.num_res_blocks:
                block.append(("up", ch))
                ds //= 2
            output_plan.append(block)
    return input_plan, middle_plan, output_plan


# ------------------------------------------------------------------ init


def init_params(gen: torch.Generator, cfg: UNetConfig, device,
                grounding: bool = True) -> Dict[str, Any]:
    """Random float32 params with the JAX init's scales and its zero leaves
    (each ResNet's conv2, proj_out, out_w, the fuser alphas, the biases)."""
    f32 = torch.float32
    mc = cfg.model_channels
    emb_ch = mc * 4

    def conv(kh, cin, cout, zero=False):
        if zero:
            return torch.zeros((kh, kh, cin, cout), dtype=f32, device=device)
        w = torch.randn((kh, kh, cin, cout), generator=gen, dtype=f32, device=device)
        return w / math.sqrt(kh * kh * cin)

    def lin(cin, cout):
        return torch.randn((cin, cout), generator=gen, dtype=f32, device=device) / math.sqrt(cin)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    def ones(n):
        return torch.ones((n,), dtype=f32, device=device)

    def res(cin, cout):
        p = {"norm1_s": ones(cin), "norm1_b": zeros(cin),
             "conv1_w": conv(3, cin, cout), "conv1_b": zeros(cout),
             "emb_w": lin(emb_ch, cout), "emb_b": zeros(cout),
             "norm2_s": ones(cout), "norm2_b": zeros(cout),
             "conv2_w": conv(3, cout, cout, zero=True), "conv2_b": zeros(cout)}
        if cin != cout:
            p["skip_w"] = conv(1, cin, cout)
            p["skip_b"] = zeros(cout)
        return p

    def attn_pack(d):
        def attn(kdim):
            return {"to_q": lin(d, d), "to_k": lin(kdim, d), "to_v": lin(kdim, d),
                    "out_w": lin(d, d), "out_b": zeros(d)}

        def ln():
            return {"scale": ones(d), "bias": zeros(d)}

        def ff():
            return {"proj_w": lin(d, d * 8), "proj_b": zeros(d * 8),
                    "out_w": lin(d * 4, d), "out_b": zeros(d)}

        blocks = []
        for _ in range(cfg.transformer_depth):
            blk = {"attn1": attn(d), "attn2": attn(cfg.context_dim), "ff": ff(),
                   "norm1": ln(), "norm2": ln(), "norm3": ln()}
            if grounding:
                blk["fuser"] = {"linear_w": lin(cfg.context_dim, d), "linear_b": zeros(d),
                                "attn": attn(d), "ff": ff(), "norm1": ln(), "norm2": ln(),
                                "alpha_attn": zeros(), "alpha_dense": zeros()}
            blocks.append(blk)
        return {"norm_scale": ones(d), "norm_bias": zeros(d),
                "proj_in_w": conv(1, d, d), "proj_in_b": zeros(d),
                "proj_out_w": conv(1, d, d, zero=True), "proj_out_b": zeros(d),
                "blocks": blocks}

    def build_block(entries):
        layers = []
        for e in entries:
            if e[0] == "conv_in":
                layers.append({"w": conv(3, e[1], e[2]), "b": zeros(e[2])})
            elif e[0] == "res":
                layers.append(res(e[1], e[2]))
            elif e[0] == "attn":
                layers.append(attn_pack(e[1]))
            else:  # down / up
                layers.append({"w": conv(3, e[1], e[1]), "b": zeros(e[1])})
        return layers

    input_plan, middle_plan, output_plan = block_plan(cfg)
    params = {
        "time_w1": lin(mc, emb_ch), "time_b1": zeros(emb_ch),
        "time_w2": lin(emb_ch, emb_ch), "time_b2": zeros(emb_ch),
        "input_blocks": [build_block(b) for b in input_plan],
        "middle_block": build_block(middle_plan),
        "output_blocks": [build_block(b) for b in output_plan],
        "out_norm_s": ones(mc), "out_norm_b": zeros(mc),
        "out_w": conv(3, mc, cfg.out_channels, zero=True), "out_b": zeros(cfg.out_channels),
    }
    if grounding:
        params["position_net"] = {"null_positive": zeros(cfg.context_dim),
                                  "null_position": zeros(POSITION_DIM),
                                  **_position_mlp(lin, zeros, cfg.context_dim)}
    return params


POSITION_DIM = 8 * 2 * 4  # Fourier xyxy: 8 bands, sin and cos, 4 coordinates
POSITION_HIDDEN = 512     # GLIGEN's PositionNet MLP width


def _position_mlp(lin, zeros, context_dim: int) -> Dict[str, Any]:
    """[features, Fourier xyxy] -> 512 -> 512 -> context_dim."""
    h = POSITION_HIDDEN
    return {"w0": lin(context_dim + POSITION_DIM, h), "b0": zeros(h),
            "w1": lin(h, h), "b1": zeros(h),
            "w2": lin(h, context_dim), "b2": zeros(context_dim)}


def init_position_net_with_image(gen: torch.Generator, cfg: UNetConfig,
                                 device) -> Dict[str, Any]:
    """The text + image PositionNet of GLIGEN's style checkpoints
    (`layers.position_net_with_image`): null text, image and position
    embeddings (zero, as at GLIGEN's init), and a text and an image MLP of
    the text net's widths (768 + 64 -> 512 -> 512 -> 768 for SD v1.4)."""
    def lin(cin, cout):
        return (torch.randn((cin, cout), generator=gen, dtype=torch.float32, device=device)
                / math.sqrt(cin))

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    cd = cfg.context_dim
    return {"null_text": zeros(cd), "null_image": zeros(cd), "null_position": zeros(POSITION_DIM),
            "text": _position_mlp(lin, zeros, cd), "image": _position_mlp(lin, zeros, cd)}


# ------------------------------------------------------------------ forward


def _res_block(p, x, emb):
    h = group_norm(x, p["norm1_s"], p["norm1_b"])
    h = conv2d(F.silu(h), p["conv1_w"], p["conv1_b"], padding=1)
    emb_out = F.silu(emb) @ p["emb_w"].float() + p["emb_b"].float()
    h = h + emb_out.to(h.dtype)[:, None, None, :]
    h = group_norm(h, p["norm2_s"], p["norm2_b"])
    h = conv2d(F.silu(h), p["conv2_w"], p["conv2_b"], padding=1)
    skip = conv2d(x, p["skip_w"], p["skip_b"]) if "skip_w" in p else x
    return skip + h


def _run_block(entries, layers, x, emb, context, objs, cfg, gate_scale):
    for e, p in zip(entries, layers):
        kind = e[0]
        if kind == "conv_in":
            x = conv2d(x, p["w"], p["b"], padding=1)
        elif kind == "res":
            x = _res_block(p, x, emb)
        elif kind == "attn":
            x = spatial_transformer(p, x, context, objs, cfg.num_heads, gate_scale)
        elif kind == "down":
            x = conv2d(x, p["w"], p["b"], stride=2, padding=1)
        elif kind == "up":
            x = conv2d(upsample2x_nearest(x), p["w"], p["b"], padding=1)
    return x


def forward(params: Dict[str, Any], cfg: UNetConfig, x: torch.Tensor, timesteps: torch.Tensor,
            context: torch.Tensor, objs: Optional[torch.Tensor] = None,
            gate_scale=1.0) -> torch.Tensor:
    """x [B, H, W, in_ch] latent; timesteps [B]; context [B, 77, 768];
    objs [B, max_objs, context_dim] grounding tokens."""
    # the time embedding stays float32 whatever the params' dtype (JAX
    # promotes the float32 embedding against bf16 weights the same way)
    t_emb = timestep_embedding(timesteps, cfg.model_channels)
    emb = F.silu(t_emb @ params["time_w1"].float() + params["time_b1"].float())
    emb = emb @ params["time_w2"].float() + params["time_b2"].float()
    input_plan, middle_plan, output_plan = block_plan(cfg)
    hs = []
    h = x
    for entries, layers in zip(input_plan, params["input_blocks"]):
        h = _run_block(entries, layers, h, emb, context, objs, cfg, gate_scale)
        hs.append(h)
    h = _run_block(middle_plan, params["middle_block"], h, emb, context, objs, cfg, gate_scale)
    for entries, layers in zip(output_plan, params["output_blocks"]):
        h = torch.cat([h, hs.pop()], dim=-1)
        h = _run_block(entries, layers, h, emb, context, objs, cfg, gate_scale)
    h = group_norm(h, params["out_norm_s"], params["out_norm_b"])
    return conv2d(F.silu(h), params["out_w"], params["out_b"], padding=1)


def grounding_tokens(params, boxes, masks, text_embeddings) -> torch.Tensor:
    """position_net wrapper."""
    return position_net(params["position_net"], boxes, masks, text_embeddings)


# ------------------------------------------------------------------ convert


def _convert_res(sd, b: str) -> Dict[str, Any]:
    p = {
        "norm1_s": sd[b + "in_layers.0.weight"], "norm1_b": sd[b + "in_layers.0.bias"],
        "conv1_w": conv_w(sd, b + "in_layers.2.weight"), "conv1_b": sd[b + "in_layers.2.bias"],
        "emb_w": lin_w(sd, b + "emb_layers.1.weight"), "emb_b": sd[b + "emb_layers.1.bias"],
        "norm2_s": sd[b + "out_layers.0.weight"], "norm2_b": sd[b + "out_layers.0.bias"],
        "conv2_w": conv_w(sd, b + "out_layers.3.weight"), "conv2_b": sd[b + "out_layers.3.bias"],
    }
    if (b + "skip_connection.weight") in sd:
        p["skip_w"] = conv_w(sd, b + "skip_connection.weight")
        p["skip_b"] = sd[b + "skip_connection.bias"]
    return p


def _convert_block(sd, entries, base: str, cfg: UNetConfig) -> List[Dict[str, Any]]:
    """One ldm block (a list of `block_plan` entries) at `base`."""
    layers = []
    for j, e in enumerate(entries):
        b = f"{base}.{j}."
        if e[0] == "conv_in":
            layers.append({"w": conv_w(sd, b + "weight"), "b": sd[b + "bias"]})
        elif e[0] == "res":
            layers.append(_convert_res(sd, b))
        elif e[0] == "attn":
            layers.append(convert_spatial_transformer(sd, b, depth=cfg.transformer_depth))
        elif e[0] == "down":
            layers.append({"w": conv_w(sd, b + "op.weight"), "b": sd[b + "op.bias"]})
        elif e[0] == "up":
            layers.append({"w": conv_w(sd, b + "conv.weight"), "b": sd[b + "conv.bias"]})
    return layers


def convert_ldm_unet(sd, cfg: UNetConfig, device="cpu") -> Dict[str, Any]:
    """ldm / GLIGEN UNet state dict (keys input_blocks.N.M....) -> param tree
    on `device`, walking `cfg`'s block plan (4 or 9 input channels); the
    GLIGEN fusers and position net where the dict has them. Accepts dicts
    with or without a leading 'model.diffusion_model.' prefix."""
    pfx = ""
    if any(k.startswith("model.diffusion_model.") for k in sd):
        pfx = "model.diffusion_model."
    sd = reading(sd, device)
    input_plan, middle_plan, output_plan = block_plan(cfg)
    params = {
        "time_w1": lin_w(sd, pfx + "time_embed.0.weight"), "time_b1": sd[pfx + "time_embed.0.bias"],
        "time_w2": lin_w(sd, pfx + "time_embed.2.weight"), "time_b2": sd[pfx + "time_embed.2.bias"],
        "input_blocks": [_convert_block(sd, b, f"{pfx}input_blocks.{i}", cfg)
                         for i, b in enumerate(input_plan)],
        "middle_block": _convert_block(sd, middle_plan, f"{pfx}middle_block", cfg),
        "output_blocks": [_convert_block(sd, b, f"{pfx}output_blocks.{i}", cfg)
                          for i, b in enumerate(output_plan)],
        "out_norm_s": sd[pfx + "out.0.weight"], "out_norm_b": sd[pfx + "out.0.bias"],
        "out_w": conv_w(sd, pfx + "out.2.weight"), "out_b": sd[pfx + "out.2.bias"],
    }
    if (pfx + "position_net.null_positive_feature") in sd:
        params["position_net"] = convert_position_net(sd, pfx + "position_net.")
    return params
