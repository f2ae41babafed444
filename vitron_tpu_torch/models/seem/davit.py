"""DaViT backbone (dual attention: spatial windows and channel groups).

Port of `vitron_tpu/models/seem/davit.py` (:22-185; reference:
modules/SEEM/demo_code/xdecoder/backbone/davit.py): per stage a conv patch
embed with its LayerNorm, then depth x (spatial block, channel block), each
block [depthwise-conv residual, pre-LN attention residual, depthwise-conv
residual, pre-LN MLP residual]. Spatial attention is plain window attention
(no shift, no bias) with window padding, through the Swin helpers; channel
attention attends over the channel axis inside each group.

The four 3x3 depthwise convs of a block are
`kernels.depthwise_conv.depthwise_conv2d`, the hand CUDA kernel on the card
(weights cast to x's dtype, as `jax.lax.conv` casts them); the patch embeds
are `layers.conv2d`.

`DaViTConfig()` is DaViT-Tiny as the DaViT paper gives it (Ding et al.,
ECCV 2022, Table 1): depths 1/1/3/1, widths 96/192/384/768, 3/6/12/24 heads
and groups, a 7x7 stride-4 stem and 2x2 stride-2 patch embeds. The JAX
default pairs those heads with widths 64/128/192/256, which 3 heads do not
divide, so it cannot run (ROADMAP C13). `convert_torch` reads the vendored
DaViT's `backbone.` keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels.depthwise_conv import depthwise_conv2d
from vitron_tpu_torch.models.diffusion.layers import conv2d, conv_w, lin_w, reading
from vitron_tpu_torch.models.seem.pixel_decoder import _ln
from vitron_tpu_torch.models.seem.swin import window_partition, window_reverse


@dataclasses.dataclass(frozen=True)
class DaViTConfig:
    depths: Tuple[int, ...] = (1, 1, 3, 1)
    embed_dims: Tuple[int, ...] = (96, 192, 384, 768)  # DaViT-Tiny (ROADMAP C13)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    num_groups: Tuple[int, ...] = (3, 6, 12, 24)
    patch_size: Tuple[int, ...] = (7, 2, 2, 2)
    patch_stride: Tuple[int, ...] = (4, 2, 2, 2)
    patch_padding: Tuple[int, ...] = (3, 0, 0, 0)
    patch_prenorm: Tuple[bool, ...] = (False, False, False, False)
    window_size: int = 7
    mlp_ratio: float = 4.0

    @staticmethod
    def tiny(**kw) -> "DaViTConfig":
        base = dict(depths=(1, 1), embed_dims=(16, 32), num_heads=(2, 4), num_groups=(2, 4),
                    patch_size=(7, 2), patch_stride=(4, 2), patch_padding=(3, 0),
                    patch_prenorm=(False, False), window_size=4)
        base.update(kw)
        return DaViTConfig(**base)


def _conv(x, w, b=None, stride=1, padding=0, groups=1):
    if w.shape[0] == w.shape[1] == 1 and stride == 1 and padding == 0 and groups == 1:
        out = x @ w[0, 0].to(x.dtype)
        return out if b is None else out + b.to(out.dtype)
    if (groups == x.shape[-1] and stride == 1 and w.shape[0] == w.shape[1]
            and w.shape[0] % 2 == 1 and padding == w.shape[0] // 2):
        return depthwise_conv2d(x, w.to(x.dtype), b)
    if groups != 1:
        raise NotImplementedError(f"grouped conv with groups={groups} is not a DaViT site")
    return conv2d(x, w, b, stride=stride, padding=padding)


def _dw_residual(p, x, h: int, w: int):
    """x + depthwise3x3(x) on the [B, h*w, C] tokens."""
    b, n, c = x.shape
    return x + _conv(x.reshape(b, h, w, c), p["w"], p["b"], padding=1, groups=c).reshape(b, n, c)


def _window_attn(p, x, h: int, w: int, heads: int, window: int):
    b, n, c = x.shape
    xs = x.reshape(b, h, w, c)
    hp, wp = -h % window, -w % window
    if hp or wp:
        xs = F.pad(xs, (0, 0, 0, wp, 0, hp))
    wins = window_partition(xs, window)
    nw, nn, _ = wins.shape
    d = c // heads
    q, k, v = (wins @ p["qkv_w"] + p["qkv_b"]).chunk(3, dim=-1)
    q = q.reshape(nw, nn, heads, d).transpose(1, 2) * (d ** -0.5)
    k = k.reshape(nw, nn, heads, d).transpose(1, 2)
    v = v.reshape(nw, nn, heads, d).transpose(1, 2)
    a = torch.softmax((q @ k.transpose(2, 3)).to(torch.float32), dim=-1).to(v.dtype)
    o = (a @ v).transpose(1, 2).reshape(nw, nn, c) @ p["proj_w"] + p["proj_b"]
    o = window_reverse(o, window, h + hp, w + wp)
    return o[:, :h, :w].reshape(b, n, c)


def _channel_attn(p, x, groups: int):
    """Attention over the channel axis inside each group; q scaled by N^-0.5."""
    b, n, c = x.shape
    d = c // groups
    q, k, v = (x @ p["qkv_w"] + p["qkv_b"]).chunk(3, dim=-1)
    q = q.reshape(b, n, groups, d).transpose(1, 2) * (n ** -0.5)
    k = k.reshape(b, n, groups, d).transpose(1, 2)
    v = v.reshape(b, n, groups, d).transpose(1, 2)
    att = torch.softmax((q.transpose(2, 3) @ k).to(torch.float32), dim=-1).to(v.dtype)
    o = (att @ v.transpose(2, 3)).transpose(2, 3)  # [b, g, n, d]
    return o.transpose(1, 2).reshape(b, n, c) @ p["proj_w"] + p["proj_b"]


def _mlp(p, x):
    return F.gelu(x @ p["fc1_w"] + p["fc1_b"]) @ p["fc2_w"] + p["fc2_b"]


def forward(params: Dict[str, Any], cfg: DaViTConfig, pixels: torch.Tensor) -> List[torch.Tensor]:
    """pixels [B, H, W, 3] -> per-stage NHWC feature maps (res2..)."""
    b = pixels.shape[0]
    outs = []
    x = h = w = None
    for si in range(len(cfg.depths)):
        ce = params["convs"][si]
        if si == 0:
            y = pixels
        else:
            if cfg.patch_prenorm[si]:
                x = _ln(x, ce["norm"])
            y = x.reshape(b, h, w, -1)
        y = _conv(y, ce["w"], ce["b"], stride=cfg.patch_stride[si], padding=cfg.patch_padding[si])
        h, w = y.shape[1], y.shape[2]
        x = y.reshape(b, h * w, -1)
        if not cfg.patch_prenorm[si] and "norm" in ce:
            x = _ln(x, ce["norm"])
        for blk in params["blocks"][si]:
            sp, ch = blk["spatial"], blk["channel"]
            x = _dw_residual(sp["conv1"], x, h, w)
            x = x + _window_attn(sp["attn"], _ln(x, sp["attn_norm"]), h, w, cfg.num_heads[si],
                                 cfg.window_size)
            x = _dw_residual(sp["conv2"], x, h, w)
            x = x + _mlp(sp["mlp"], _ln(x, sp["mlp_norm"]))
            x = _dw_residual(ch["conv1"], x, h, w)
            x = x + _channel_attn(ch["attn"], _ln(x, ch["attn_norm"]), cfg.num_groups[si])
            x = _dw_residual(ch["conv2"], x, h, w)
            x = x + _mlp(ch["mlp"], _ln(x, ch["mlp_norm"]))
        outs.append(x.reshape(b, h, w, -1))
    return outs


def init_params(gen: torch.Generator, cfg: DaViTConfig, device) -> Dict[str, Any]:
    """Random params with the JAX init's shapes and scales (N(0, 0.02^2))."""
    def normal(shape):
        return torch.randn(shape, generator=gen, device=device) * 0.02

    def zeros(n):
        return torch.zeros((n,), device=device)

    def ln(c):
        return {"scale": torch.ones((c,), device=device), "bias": zeros(c)}

    def block(c, ffn):
        def dw():
            return {"w": normal((3, 3, 1, c)), "b": zeros(c)}

        return {"conv1": dw(), "attn_norm": ln(c),
                "attn": {"qkv_w": normal((c, 3 * c)), "qkv_b": zeros(3 * c),
                         "proj_w": normal((c, c)), "proj_b": zeros(c)},
                "conv2": dw(), "mlp_norm": ln(c),
                "mlp": {"fc1_w": normal((c, ffn)), "fc1_b": zeros(ffn),
                        "fc2_w": normal((ffn, c)), "fc2_b": zeros(c)}}

    convs, blocks = [], []
    for si in range(len(cfg.depths)):
        cin = 3 if si == 0 else cfg.embed_dims[si - 1]
        c = cfg.embed_dims[si]
        k = cfg.patch_size[si]
        convs.append({"w": normal((k, k, cin, c)), "b": zeros(c),
                      "norm": ln(cin if cfg.patch_prenorm[si] else c)})
        ffn = int(c * cfg.mlp_ratio)
        blocks.append([{"spatial": block(c, ffn), "channel": block(c, ffn)}
                       for _ in range(cfg.depths[si])])
    return {"convs": convs, "blocks": blocks}


def convert_torch(sd, cfg: DaViTConfig, prefix: str = "backbone.", device="cpu") -> Dict[str, Any]:
    """Vendored DaViT state dict (convs.{i}.*, blocks.{i}.{j}.{spatial_block,
    channel_block}.*) -> param tree on `device` (the JAX `convert_torch`,
    :201)."""
    sd = reading(sd, device)

    def g(k):
        return sd[prefix + k]

    def lw(k):
        return lin_w(sd, prefix + k)

    def ln(stem):
        return {"scale": g(stem + ".weight"), "bias": g(stem + ".bias")}

    def dw(stem):
        return {"w": conv_w(sd, prefix + stem + ".dw.weight"), "b": g(stem + ".dw.bias")}

    def half(stem, attn):
        return {
            "conv1": dw(stem + ".conv1.fn"),
            "attn_norm": ln(f"{stem}.{attn}.norm"),
            "attn": {"qkv_w": lw(f"{stem}.{attn}.fn.qkv.weight"),
                     "qkv_b": g(f"{stem}.{attn}.fn.qkv.bias"),
                     "proj_w": lw(f"{stem}.{attn}.fn.proj.weight"),
                     "proj_b": g(f"{stem}.{attn}.fn.proj.bias")},
            "conv2": dw(stem + ".conv2.fn"),
            "mlp_norm": ln(stem + ".ffn.norm"),
            "mlp": {"fc1_w": lw(stem + ".ffn.fn.net.fc1.weight"),
                    "fc1_b": g(stem + ".ffn.fn.net.fc1.bias"),
                    "fc2_w": lw(stem + ".ffn.fn.net.fc2.weight"),
                    "fc2_b": g(stem + ".ffn.fn.net.fc2.bias")},
        }

    convs, blocks = [], []
    for si in range(len(cfg.depths)):
        convs.append({"w": conv_w(sd, prefix + f"convs.{si}.proj.weight"),
                      "b": g(f"convs.{si}.proj.bias"), "norm": ln(f"convs.{si}.norm")})
        blocks.append([{"spatial": half(f"blocks.{si}.{bi}.spatial_block", "window_attn"),
                        "channel": half(f"blocks.{si}.{bi}.channel_block", "channel_attn")}
                       for bi in range(cfg.depths[si])])
    return {"convs": convs, "blocks": blocks}
