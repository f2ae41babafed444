"""MiDaS/DPT monocular depth, StableVideo's depth annotator.

Port of `vitron_tpu/models/diffusion/depth.py` (the vendored MiDaS DPT,
reference annotator/midas): NHWC activations, HWIO conv weights and the JAX
param tree, all plain torch (no kernel of the port sits under it).

`dpt_hybrid` (the reference default): a ResNetV2-50 stem (weight-
standardized convs + GroupNorm(32), stages (3, 4, 9), SAME padding) feeding
a ViT-B on the 1/16 feature map; reassemble hooks at ResNet stages 0 and 1
and transformer blocks 8 and 11 through the 'project' readout; then the
scratch head (per-scale 3x3 convs, residual fusion refinenets, x2
bilinear align_corners=True, the output conv stack). The JAX package's
`dpt_large` variant is not ported: nothing calls it (the reference
annotator is the hybrid). `convert_midas_torch` waits for the loaders
(ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitron_tpu_torch.media.preprocess import _resize_hw


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    variant: str = "dpt_hybrid"          # the only variant ported
    image_size: int = 384                # the checkpoint's native resolution
    patch_size: int = 16                 # the token grid's stride
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    hooks: Tuple[int, ...] = (8, 11)     # the two transformer hooks
    features: int = 256
    reassemble_dims: Tuple[int, ...] = (256, 512, 768, 768)
    resnet_layers: Tuple[int, ...] = (3, 4, 9)
    resnet_channels: Tuple[int, ...] = (256, 512, 1024)
    stem_width: int = 64
    gn_groups: int = 32

    @staticmethod
    def dpt_hybrid(**kw) -> "DPTConfig":
        return DPTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "DPTConfig":
        base = dict(variant="dpt_hybrid", image_size=64, hidden_size=32, num_layers=2,
                    num_heads=4, mlp_dim=64, hooks=(0, 1), features=16,
                    reassemble_dims=(8, 16, 32, 32), resnet_layers=(1, 1, 1),
                    resnet_channels=(8, 16, 32), stem_width=8, gn_groups=2)
        base.update(kw)
        return DPTConfig(**base)


# ---------------------------------------------------------------- primitives


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, b=None, stride: int = 1, padding="SAME"):
    """x [B, H, W, C] * w [kh, kw, C, O]; padding "SAME" or [(lo, hi), (lo,
    hi)]. 1x1 stride-1 convs are matmuls."""
    kh, kw = w.shape[:2]
    if kh == kw == 1 and stride == 1:
        y = x @ w[0, 0].to(x.dtype)
        return y if b is None else y + b
    if padding == "SAME":
        (t, bt), (l, r) = _same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw, stride)
    else:
        (t, bt), (l, r) = padding
    xp = F.pad(x.permute(0, 3, 1, 2), (l, r, t, bt))
    y = F.conv2d(xp, w.permute(3, 2, 0, 1).to(x.dtype), stride=stride).permute(0, 2, 3, 1)
    return y if b is None else y + b


def _std_weight(w, eps: float = 1e-8):
    """Weight standardization (timm StdConv2dSame): per output channel, zero
    mean and unit (biased) variance over (kh, kw, cin)."""
    w32 = w.to(torch.float32)
    mu = w32.mean(dim=(0, 1, 2), keepdim=True)
    var = w32.var(dim=(0, 1, 2), keepdim=True, unbiased=False)
    return ((w32 - mu) * torch.rsqrt(var + eps)).to(w.dtype)


def _group_norm(x, p, groups: int, eps: float = 1e-5, act: bool = True):
    b, h, w, c = x.shape
    xg = x.reshape(b, h, w, groups, c // groups).to(torch.float32)
    mu = xg.mean(dim=(1, 2, 4), keepdim=True)
    var = xg.var(dim=(1, 2, 4), keepdim=True, unbiased=False)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(b, h, w, c) * p["scale"] + p["bias"]
    if act:
        y = F.relu(y)
    return y.to(x.dtype)


def _ln(x, p, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def resize_align_corners(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize with torch align_corners=True semantics, as the JAX
    package computes it (a separable gather-interpolation; x is NHWC)."""
    b, h, w, c = x.shape

    def axis_weights(n_in, n_out):
        if n_in == 1 or n_out == 1:
            z = torch.zeros(n_out, dtype=torch.int64, device=x.device)
            return z, z, torch.zeros(n_out, dtype=torch.float32, device=x.device)
        f = torch.arange(n_out, device=x.device) * ((n_in - 1) / (n_out - 1))
        i0 = torch.floor(f).to(torch.int64)
        return i0, torch.clamp(i0 + 1, max=n_in - 1), (f - i0).to(torch.float32)

    y0, y1, wy = axis_weights(h, oh)
    x32 = x.to(torch.float32)
    rows = x32[:, y0] * (1.0 - wy)[None, :, None, None] + x32[:, y1] * wy[None, :, None, None]
    x0, x1, wx = axis_weights(w, ow)
    out = rows[:, :, x0] * (1.0 - wx)[None, None, :, None] + rows[:, :, x1] * wx[None, None, :,
                                                                                 None]
    return out.to(x.dtype)


# ----------------------------------------------------- the ResNetV2 hybrid stem


def _bottleneck(x, p, groups: int, stride: int):
    if "down_w" in p:
        sc = _group_norm(_conv(x, _std_weight(p["down_w"]), stride=stride), p["down_norm"],
                         groups, act=False)
    else:
        sc = x
    y = _group_norm(_conv(x, _std_weight(p["w1"])), p["n1"], groups)
    y = _group_norm(_conv(y, _std_weight(p["w2"]), stride=stride), p["n2"], groups)
    y = _group_norm(_conv(y, _std_weight(p["w3"])), p["n3"], groups, act=False)
    return F.relu(y + sc)


def _max_pool_same(x, k: int = 3, s: int = 2):
    """A k x k max pool with stride s and SAME padding by -inf (NHWC)."""
    (t, bt), (l, r) = _same_pads(x.shape[1], k, s), _same_pads(x.shape[2], k, s)
    xp = F.pad(x.permute(0, 3, 1, 2), (l, r, t, bt), value=float("-inf"))
    return F.max_pool2d(xp, k, s).permute(0, 2, 3, 1)


def _resnet_stem(params, cfg: DPTConfig, x):
    """-> the outputs of the three stages (1/4, 1/8, 1/16)."""
    g = cfg.gn_groups
    x = _group_norm(_conv(x, _std_weight(params["stem_w"]), stride=2), params["stem_norm"], g)
    x = _max_pool_same(x)
    outs = []
    for si, blocks in enumerate(params["stages"]):
        for bi, bp in enumerate(blocks):
            x = _bottleneck(x, bp, g, stride=2 if (si > 0 and bi == 0) else 1)
        outs.append(x)
    return outs


# ---------------------------------------------------------------- ViT trunk


def _vit_block(x, p, heads: int):
    b, n, c = x.shape
    d = c // heads
    xn = _ln(x, p["ln1"])
    q, k, v = (xn @ p["qkv_w"] + p["qkv_b"]).chunk(3, dim=-1)
    q, k, v = (t.reshape(b, n, heads, d) for t in (q, k, v))
    a = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / math.sqrt(d)
    a = torch.softmax(a, dim=-1).to(v.dtype)
    att = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(b, n, c)
    x = x + att @ p["proj_w"] + p["proj_b"]
    h = F.gelu(_ln(x, p["ln2"]) @ p["fc1_w"] + p["fc1_b"])
    return x + h @ p["fc2_w"] + p["fc2_b"]


def _resize_pos_embed(pos, gh: int, gw: int):
    """The class token kept, the grid resized bilinearly (jax.image.resize's
    "linear", as the JAX package does)."""
    tok, grid = pos[:1], pos[1:]
    gs = int(round(math.sqrt(grid.shape[0])))
    if (gs, gs) == (gh, gw):
        return pos
    grid = _resize_hw(grid.reshape(gs, gs, -1), gh, gw, "linear")
    return torch.cat([tok, grid.reshape(gh * gw, -1)], dim=0)


def _vit_trunk(params, cfg: DPTConfig, tokens, gh: int, gw: int) -> List[torch.Tensor]:
    """tokens [B, gh*gw, C] -> the hooked blocks' outputs."""
    b = tokens.shape[0]
    x = torch.cat([params["cls"].expand(b, 1, cfg.hidden_size), tokens], dim=1)
    x = x + _resize_pos_embed(params["pos_emb"], gh, gw)
    hooked = []
    for i, blk in enumerate(params["blocks"]):
        x = _vit_block(x, blk, cfg.num_heads)
        if i in cfg.hooks:
            hooked.append(x)
    return hooked


def _readout_project(tokens_with_cls, p):
    """The 'project' readout: the class token concatenated onto every patch
    token, Linear(2C -> C) + GELU."""
    cls, tokens = tokens_with_cls[:, :1], tokens_with_cls[:, 1:]
    cat = torch.cat([tokens, cls.expand_as(tokens)], dim=-1)
    return F.gelu(cat @ p["w"] + p["b"])


# ---------------------------------------------------------------- the model


def forward(params: Dict[str, Any], cfg: DPTConfig, image: torch.Tensor) -> torch.Tensor:
    """image [B, H, W, 3] normalized (x / 127.5 - 1) -> relative inverse
    depth [B, H, W]."""
    b, H, W, _ = image.shape
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    pad1 = [(1, 1), (1, 1)]
    if cfg.variant == "dpt_hybrid":
        s0, s1, s2 = _resnet_stem(params["resnet"], cfg, image)
        tokens = s2.reshape(b, gh * gw, s2.shape[-1]) @ params["patch_w"] + params["patch_b"]
        h3, h4 = _vit_trunk(params, cfg, tokens, gh, gw)
        l3 = _readout_project(h3, params["readout"][0]).reshape(b, gh, gw, -1)
        l4 = _readout_project(h4, params["readout"][1]).reshape(b, gh, gw, -1)
        feats = [s0, s1, _conv(l3, params["post3"]["w"], params["post3"]["b"]),
                 _conv(_conv(l4, params["post4"]["w"], params["post4"]["b"]),
                       params["post4"]["w2"], params["post4"]["b2"], stride=2, padding=pad1)]
    else:
        raise ValueError(f"DPT variant {cfg.variant!r} is not ported (only dpt_hybrid)")
    rn = [_conv(f, params["scratch"][i]["w"], padding=pad1) for i, f in enumerate(feats)]

    def rcu(y, u):
        """ResidualConvUnit_custom: relu-conv-relu-conv plus the input."""
        h = _conv(F.relu(y), u["w1"], u["b1"], padding=pad1)
        return _conv(F.relu(h), u["w2"], u["b2"], padding=pad1) + y

    def fusion(i, x_up, skip):
        """FeatureFusionBlock_custom: add RCU1(skip), RCU2, x2 bilinear
        align_corners=True, the 1x1 out conv."""
        fp = params["fusion"][i]
        if skip is not None:
            x_up = x_up + rcu(skip, fp["res1"])
        x_up = rcu(x_up, fp["res2"])
        x_up = resize_align_corners(x_up, x_up.shape[1] * 2, x_up.shape[2] * 2)
        return _conv(x_up, fp["out_w"], fp["out_b"])

    path = fusion(3, rn[3], None)
    for i in (2, 1, 0):
        path = fusion(i, path, rn[i])
    hd = params["head"]
    y = _conv(path, hd["w1"], hd["b1"], padding=pad1)
    y = resize_align_corners(y, y.shape[1] * 2, y.shape[2] * 2)
    y = F.relu(_conv(y, hd["w2"], hd["b2"], padding=pad1))
    return F.relu(_conv(y, hd["w3"], hd["b3"]))[..., 0]


def depth_hint(params, cfg: DPTConfig, image_uint8: np.ndarray,
               run_size: Optional[int] = None) -> np.ndarray:
    """The MidasDetector hint: pixels to [-1, 1], DPT at the input size
    rounded down to the model's full stride (or at `run_size`), min-max
    normalized to [0, 1], 3 channels at the input resolution [H, W, 3]."""
    dev = params["cls"].device
    h, w = image_uint8.shape[:2]
    x = torch.as_tensor(np.asarray(image_uint8), dtype=torch.float32, device=dev) / 127.5 - 1.0
    if run_size is None:
        stride = 2 * cfg.patch_size
        rh, rw = max(stride, h - h % stride), max(stride, w - w % stride)
    else:
        rh = rw = run_size
    if (rh, rw) != (h, w):
        x = _resize_hw(x, rh, rw, "linear")
    d = forward(params, cfg, x[None])[0]
    d = d - d.min()
    d = d / torch.clamp(d.max(), min=1e-6)
    if (rh, rw) != (h, w):
        d = _resize_hw(d[..., None], h, w, "linear")[..., 0]
    return torch.stack([d] * 3, dim=-1).cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------- init


def init_params(gen: torch.Generator, cfg: DPTConfig, device) -> Dict[str, Any]:
    """Random float32 params with the JAX init's scales (`gen` on `device`)."""
    c, f = cfg.hidden_size, cfg.features

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32, device=device)

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def dense(cin, cout):
        return randn(cin, cout) / math.sqrt(cin)

    def conv(kh, kw, cin, cout):
        return randn(kh, kw, cin, cout) / math.sqrt(kh * kw * cin)

    def norm(ch):
        return {"scale": torch.ones((ch,), device=device), "bias": zeros(ch)}

    def res_unit():
        return {"w1": conv(3, 3, f, f), "b1": zeros(f), "w2": conv(3, 3, f, f), "b2": zeros(f)}

    n_tok = (cfg.image_size // cfg.patch_size) ** 2 + 1
    params: Dict[str, Any] = {
        "cls": randn(1, 1, c) * 0.02,
        "pos_emb": randn(n_tok, c) * 0.02,
        "blocks": [{"ln1": norm(c), "ln2": norm(c),
                    "qkv_w": dense(c, 3 * c), "qkv_b": zeros(3 * c),
                    "proj_w": dense(c, c), "proj_b": zeros(c),
                    "fc1_w": dense(c, cfg.mlp_dim), "fc1_b": zeros(cfg.mlp_dim),
                    "fc2_w": dense(cfg.mlp_dim, c), "fc2_b": zeros(c)}
                   for _ in range(cfg.num_layers)],
        "scratch": [{"w": conv(3, 3, cfg.reassemble_dims[i], f)} for i in range(4)],
        "fusion": [{"res1": res_unit(), "res2": res_unit(), "out_w": conv(1, 1, f, f),
                    "out_b": zeros(f)} for _ in range(4)],
        "head": {"w1": conv(3, 3, f, f // 2), "b1": zeros(f // 2),
                 "w2": conv(3, 3, f // 2, 32), "b2": zeros(32),
                 "w3": conv(1, 1, 32, 1), "b3": zeros(1)},
    }
    d3, d4 = cfg.reassemble_dims[2], cfg.reassemble_dims[3]
    params["post3"] = {"w": conv(1, 1, c, d3), "b": zeros(d3)}
    params["post4"] = {"w": conv(1, 1, c, d4), "b": zeros(d4), "w2": conv(3, 3, d4, d4),
                       "b2": zeros(d4)}
    stages, cin = [], cfg.stem_width
    for si, n_blocks in enumerate(cfg.resnet_layers):
        cout = cfg.resnet_channels[si]
        mid = cout // 4
        blocks = []
        for bi in range(n_blocks):
            bp = {"w1": conv(1, 1, cin if bi == 0 else cout, mid), "n1": norm(mid),
                  "w2": conv(3, 3, mid, mid), "n2": norm(mid),
                  "w3": conv(1, 1, mid, cout), "n3": norm(cout)}
            if bi == 0:
                bp["down_w"] = conv(1, 1, cin, cout)
                bp["down_norm"] = norm(cout)
            blocks.append(bp)
        stages.append(blocks)
        cin = cout
    params["resnet"] = {"stem_w": conv(7, 7, 3, cfg.stem_width),
                        "stem_norm": norm(cfg.stem_width), "stages": stages}
    params["patch_w"] = dense(cfg.resnet_channels[-1], c)
    params["readout"] = [{"w": dense(2 * c, c), "b": zeros(c)} for _ in range(2)]
    params["patch_b"] = zeros(c)
    return params
