"""ResNet backbone (SEEM's third registry-selectable backbone).

Port of `vitron_tpu/models/seem/resnet.py` (:20-119; the detectron2-style
ResNet the reference vendors): bottleneck blocks with frozen BatchNorm (an
affine from the stored statistics), a 7x7 stride-2 stem and a 3x3 stride-2
max pool, res2..res5 at strides 4/8/16/32. NHWC; 1x1 convs are matmuls and
the rest `layers.conv2d`, as XLA lowered them: no kernel runs here. The
checkpoint converter waits for the loaders (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from vitron_tpu_torch.models.diffusion.layers import conv2d


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stem_channels: int = 64
    stage_blocks: Tuple[int, ...] = (3, 4, 6, 3)   # ResNet-50
    stage_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    bottleneck: bool = True

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(**kw)

    @staticmethod
    def resnet101(**kw) -> "ResNetConfig":
        kw.setdefault("stage_blocks", (3, 4, 23, 3))
        return ResNetConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "ResNetConfig":
        base = dict(stem_channels=8, stage_blocks=(1, 1), stage_channels=(16, 32))
        base.update(kw)
        return ResNetConfig(**base)


def frozen_bn(x, p, eps: float = 1e-5):
    """y = (x - mean) / sqrt(var + eps) * gamma + beta from the stored
    statistics, the affine folded in float32 and applied in x's dtype."""
    f32 = torch.float32
    inv = torch.rsqrt(p["var"].to(f32) + eps)
    w = p["gamma"].to(f32) * inv
    b = p["beta"].to(f32) - p["mean"].to(f32) * p["gamma"].to(f32) * inv
    return x * w.to(x.dtype) + b.to(x.dtype)


def _bottleneck(p, x, stride: int):
    out = torch.relu(frozen_bn(conv2d(x, p["w1"]), p["bn1"]))
    out = torch.relu(frozen_bn(conv2d(out, p["w2"], stride=stride, padding=1), p["bn2"]))
    out = frozen_bn(conv2d(out, p["w3"]), p["bn3"])
    if "w_sc" in p:
        x = frozen_bn(conv2d(x, p["w_sc"], stride=stride), p["bn_sc"])
    return torch.relu(x + out)


def forward(params: Dict[str, Any], cfg: ResNetConfig, pixels: torch.Tensor) -> List[torch.Tensor]:
    """pixels [B, H, W, 3] normalized -> [res2..res{N+1}] NHWC features."""
    x = torch.relu(frozen_bn(conv2d(pixels, params["stem_w"], stride=2, padding=3),
                             params["stem_bn"]))
    # 3x3 stride-2 max pool over -inf padding of 1
    x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2, padding=1).permute(0, 2, 3, 1)
    outs = []
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            x = _bottleneck(blk, x, (1 if si == 0 else 2) if bi == 0 else 1)
        outs.append(x)
    return outs


def init_params(gen: torch.Generator, cfg: ResNetConfig, device) -> Dict[str, Any]:
    """Random params with the JAX init's shapes and scales: He-scaled convs,
    identity BatchNorm statistics."""
    def conv(kh, kw, cin, cout):
        return (torch.randn((kh, kw, cin, cout), generator=gen, device=device)
                * (kh * kw * cin) ** -0.5)

    def bn(c):
        return {"gamma": torch.ones((c,), device=device), "beta": torch.zeros((c,), device=device),
                "mean": torch.zeros((c,), device=device), "var": torch.ones((c,), device=device)}

    stages = []
    cin = cfg.stem_channels
    for n_blocks, cout in zip(cfg.stage_blocks, cfg.stage_channels):
        mid = cout // 4
        blocks = []
        for bi in range(n_blocks):
            blk = {"w1": conv(1, 1, cin, mid), "bn1": bn(mid),
                   "w2": conv(3, 3, mid, mid), "bn2": bn(mid),
                   "w3": conv(1, 1, mid, cout), "bn3": bn(cout)}
            if bi == 0:
                blk["w_sc"] = conv(1, 1, cin, cout)
                blk["bn_sc"] = bn(cout)
            blocks.append(blk)
            cin = cout
        stages.append(blocks)
    return {"stem_w": conv(7, 7, 3, cfg.stem_channels), "stem_bn": bn(cfg.stem_channels),
            "stages": stages}
