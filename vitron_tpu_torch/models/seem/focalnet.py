"""FocalNet backbone (FocalNet-L for SEEM).

Port of `vitron_tpu/models/seem/focalnet.py` (:22-196): the same config,
param tree and NHWC layout (reference: modules/SEEM/demo_code/xdecoder/
backbone/focal.py:24-597; embed 192, depths [2,2,18,2], focal levels 4,
window 3, conv-embed stem, post-LN blocks, layerscale, scaling modulator).
Emits the res2..res5 pyramid (strides 4/8/16/32).

In `_conv`, 1x1 convs are matmuls and the focal levels' full depthwise convs
(k = 3/5/7/9) go to `kernels.depthwise_conv.depthwise_conv2d`, the hand CUDA
kernel on the card; the k7/s4 stem and the k3/s2 downsamples are
`layers.conv2d` (cuDNN), as XLA lowered them without a kernel. The
checkpoint converter (`convert_torch`) waits for the SEEM weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels.depthwise_conv import depthwise_conv2d
from vitron_tpu_torch.models.diffusion.layers import conv2d
from vitron_tpu_torch.models.vision.vit import layer_norm


@dataclasses.dataclass(frozen=True)
class FocalNetConfig:
    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    focal_levels: Tuple[int, ...] = (4, 4, 4, 4)
    focal_windows: Tuple[int, ...] = (3, 3, 3, 3)
    mlp_ratio: float = 4.0
    use_postln: bool = True
    use_layerscale: bool = True
    scaling_modulator: bool = True
    layer_norm_eps: float = 1e-5

    @property
    def num_stages(self) -> int:
        return len(self.depths)

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(self.embed_dim * 2 ** i for i in range(self.num_stages))

    @staticmethod
    def focall(**kw) -> "FocalNetConfig":
        return FocalNetConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "FocalNetConfig":
        base = dict(embed_dim=16, depths=(1, 1), focal_levels=(2, 2),
                    focal_windows=(3, 3))
        base.update(kw)
        return FocalNetConfig(**base)


def _ln(x, p, eps=1e-5):
    return layer_norm(x, p, eps)


def _conv(x, w, b, stride=1, padding=0, groups=1):
    if w.shape[0] == w.shape[1] == 1 and stride == 1 and padding == 0 and groups == 1:
        out = x @ w[0, 0].to(x.dtype)
        return out if b is None else out + b.to(out.dtype)
    # full depthwise (the focal-level convs): the read-once kernel
    if (groups == x.shape[-1] and stride == 1 and w.shape[0] == w.shape[1]
            and w.shape[0] % 2 == 1 and padding == w.shape[0] // 2):
        return depthwise_conv2d(x, w, b)
    if groups != 1:
        raise NotImplementedError(f"grouped conv with groups={groups} is not a FocalNet site")
    return conv2d(x, w, b, stride=stride, padding=padding)


def focal_modulation(p, x, cfg: FocalNetConfig, level: int):
    """x: [B, H, W, C] (focal.py:44-116)."""
    c = x.shape[-1]
    L = cfg.focal_levels[level]
    f = x @ p["f_w"] + p["f_b"]
    q, ctx, gates = f[..., :c], f[..., c:2 * c], f[..., 2 * c:]
    ctx_all = torch.zeros_like(ctx)
    for l in range(L):
        k = cfg.focal_windows[level] + 2 * l
        ctx = F.gelu(_conv(ctx, p["focal_w"][l], None, padding=k // 2, groups=c))
        ctx_all = ctx_all + ctx * gates[..., l:l + 1]
    ctx_global = F.gelu(ctx.mean(dim=(1, 2), keepdim=True))
    ctx_all = ctx_all + ctx_global * gates[..., L:L + 1]
    if cfg.scaling_modulator:
        ctx_all = ctx_all / (L + 1)
    x_out = q * _conv(ctx_all, p["h_w"], p["h_b"])
    return x_out @ p["proj_w"] + p["proj_b"]


def _block(p, x, cfg: FocalNetConfig, level: int):
    """FocalModulationBlock with post-LN + layerscale (focal.py:166-196)."""
    shortcut = x
    if not cfg.use_postln:
        x = _ln(x, p["norm1"], cfg.layer_norm_eps)
    x = focal_modulation(p["mod"], x, cfg, level)
    if cfg.use_postln:
        x = _ln(x, p["norm1"], cfg.layer_norm_eps)
    g1 = p.get("gamma_1", 1.0)
    g2 = p.get("gamma_2", 1.0)
    x = shortcut + g1 * x
    if cfg.use_postln:
        h = F.gelu(x @ p["fc1_w"] + p["fc1_b"])
        h = h @ p["fc2_w"] + p["fc2_b"]
        x = x + g2 * _ln(h, p["norm2"], cfg.layer_norm_eps)
    else:
        xn = _ln(x, p["norm2"], cfg.layer_norm_eps)
        h = F.gelu(xn @ p["fc1_w"] + p["fc1_b"])
        x = x + g2 * (h @ p["fc2_w"] + p["fc2_b"])
    return x


def forward(params: Dict[str, Any], cfg: FocalNetConfig, pixels: torch.Tensor
            ) -> List[torch.Tensor]:
    """pixels: [B, H, W, 3] (already pixel-mean/std normalized) ->
    [res2..res{2+n}] NHWC feature maps."""
    # conv-embed stem: k7 s4 p2 (focal.py:307-311) + LN
    x = _conv(pixels, params["stem_w"], params["stem_b"], stride=4, padding=2)
    x = _ln(x, params["stem_norm"], cfg.layer_norm_eps)
    outs = []
    for si in range(cfg.num_stages):
        stage = params["stages"][si]
        for blk in stage["blocks"]:
            x = _block(blk, x, cfg, si)
        outs.append(_ln(x, params["out_norms"][si], cfg.layer_norm_eps))
        if si < cfg.num_stages - 1:
            # downsample: conv k3 s2 p1 + LN (focal.py:308-312, is_stem=False)
            x = _conv(x, stage["down_w"], stage["down_b"], stride=2, padding=1)
            x = _ln(x, stage["down_norm"], cfg.layer_norm_eps)
    return outs


def init_params(gen: torch.Generator, cfg: FocalNetConfig, device) -> Dict[str, Any]:
    """Random-init param tree (tests, smoke runs) with the JAX package's
    shapes and scales; `gen` lives on `device`."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def dense(cin, cout):
        return normal((cin, cout), cin ** -0.5)

    def conv(kh, kw, cin, cout, groups=1):
        return normal((kh, kw, cin // groups, cout), (kh * kw * cin // groups) ** -0.5)

    def zeros(n):
        return torch.zeros((n,), device=device)

    def ln(c):
        return {"scale": torch.ones((c,), device=device), "bias": zeros(c)}

    stages = []
    for si in range(cfg.num_stages):
        c = cfg.dims[si]
        L = cfg.focal_levels[si]
        hidden = int(c * cfg.mlp_ratio)
        blocks = []
        for _ in range(cfg.depths[si]):
            blk = {
                "norm1": ln(c), "norm2": ln(c),
                "mod": {
                    "f_w": dense(c, 2 * c + L + 1), "f_b": zeros(2 * c + L + 1),
                    "focal_w": [conv(cfg.focal_windows[si] + 2 * l,
                                     cfg.focal_windows[si] + 2 * l, c, c, groups=c)
                                for l in range(L)],
                    "h_w": conv(1, 1, c, c), "h_b": zeros(c),
                    "proj_w": dense(c, c), "proj_b": zeros(c),
                },
                "fc1_w": dense(c, hidden), "fc1_b": zeros(hidden),
                "fc2_w": dense(hidden, c), "fc2_b": zeros(c),
            }
            if cfg.use_layerscale:
                blk["gamma_1"] = torch.full((c,), 1e-4, device=device)
                blk["gamma_2"] = torch.full((c,), 1e-4, device=device)
            blocks.append(blk)
        stage = {"blocks": blocks}
        if si < cfg.num_stages - 1:
            stage["down_w"] = conv(3, 3, c, 2 * c)
            stage["down_b"] = zeros(2 * c)
            stage["down_norm"] = ln(2 * c)
        stages.append(stage)
    return {
        "stem_w": conv(7, 7, 3, cfg.embed_dim), "stem_b": zeros(cfg.embed_dim),
        "stem_norm": ln(cfg.embed_dim),
        "stages": stages,
        "out_norms": [ln(cfg.dims[i]) for i in range(cfg.num_stages)],
    }
