"""The ZeroScope / T2V video UNet (UNetSD_T2VBase), text-to-video half.

Port of the t2v half of `vitron_tpu/models/diffusion/unet_sd_video.py`:
`UNetSDVideoConfig` (:61-113), `block_plan` (:118-173), the pieces
(:178-351), `_run_block` and `forward` (:379-494) and `init_params`
(:511-627). Activations are [B, F, H, W, C] as in JAX; spatial layers fold
the frames into the batch, temporal layers see per-pixel frame sequences.
Three kernels sit under it on CUDA tensors, besides the group-norm sums (B8)
of every norm:
- every res block ends in `video_unet.temporal_conv_block` (B6, the
  temporal k=3 conv, four times);
- every temporal transformer's two frame self-attentions go to
  `kernels.temporal_attention.frame_attention` (B7), in float32 and bf16;
- every transformer's feed-forward is `layers.geglu_ff` (B3).
The spatial attention sites have 720, 180 and 45 tokens at 320x576, under
`VITRON_FLASH_MIN`, so they stay on `layers._mha`'s einsum path, as in JAX.

Waits (ROADMAP A11): the i2vgen variant (`variant == "i2vgen"` in `forward`,
`adaptive_avg_pool2d`, `transformer_v2`; task G), `quantize_params` (W8A8,
A17), `convert_torch` (the checkpoint converter, A7), and the TPU layout
experiment `_temporal_mha_nmajor` (`VITRON_TATTN=nmajor`), which computes
the same function as the default path and is not ported.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels.quantization import matmul_maybe_quantized as mmq
from vitron_tpu_torch.kernels.temporal_attention import frame_attention
from vitron_tpu_torch.models.diffusion.layers import (basic_transformer_block, conv2d, geglu_ff,
                                                      group_norm, layer_norm, timestep_embedding,
                                                      upsample2x_nearest)
from vitron_tpu_torch.models.diffusion.video_unet import temporal_conv_block


@dataclasses.dataclass(frozen=True)
class UNetSDVideoConfig:
    """The JAX config, field for field; y_dim, num_tokens,
    adapter_transformer_layers and concat_dim are read only by the i2vgen
    variant (task G)."""

    variant: str = "t2v"                      # "t2v" ("i2vgen" waits for task G)
    in_dim: int = 4
    dim: int = 512
    y_dim: int = 1024
    context_dim: int = 1024
    out_dim: int = 4
    num_tokens: int = 4
    dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8                         # init-block temporal heads
    head_dim: int = 64
    num_res_blocks: int = 2
    attn_scales: Tuple[float, ...] = (0.5, 0.25, 0.125)
    temporal_attention: bool = True
    use_fps_condition: bool = False
    adapter_transformer_layers: int = 1

    @property
    def concat_dim(self) -> int:
        return self.in_dim

    @property
    def embed_dim(self) -> int:
        return self.dim * 4

    @staticmethod
    def t2v(**kw) -> "UNetSDVideoConfig":
        """configs/t2v_train.yaml:32-51."""
        base = dict(variant="t2v", in_dim=4, y_dim=1024, context_dim=1024, out_dim=4,
                    dim_mult=(1, 2, 4, 4), num_heads=8, head_dim=64, num_res_blocks=2)
        base.update(kw)
        return UNetSDVideoConfig(**base)

    @staticmethod
    def tiny(variant: str = "t2v", **kw) -> "UNetSDVideoConfig":
        base = dict(variant=variant, in_dim=4, dim=32, y_dim=16, context_dim=1024, out_dim=4,
                    num_tokens=4, dim_mult=(1, 2), num_heads=2, head_dim=16,
                    num_res_blocks=1, attn_scales=(1.0, 0.5))
        base.update(kw)
        return UNetSDVideoConfig(**base)


def block_plan(cfg: UNetSDVideoConfig):
    """The reference construction loops as entries ('conv_in', cin, cout) |
    ('res', cin, cout) | ('sattn', ch, heads) | ('tattn', ch, heads, inner) |
    ('down', ch) | ('up', ch), in (input, middle, output) blocks."""
    dim = cfg.dim
    hd = cfg.head_dim
    enc_dims = [dim * u for u in (1,) + tuple(cfg.dim_mult)]
    dec_dims = [dim * u for u in (cfg.dim_mult[-1],) + tuple(cfg.dim_mult[::-1])]
    in0 = cfg.in_dim + (cfg.concat_dim if cfg.variant == "i2vgen" else 0)

    init: List[tuple] = [("conv_in", in0, dim)]
    if cfg.temporal_attention:
        init.append(("tattn", dim, cfg.num_heads, cfg.num_heads * hd))
    input_plan: List[List[tuple]] = [init]
    skips = [dim]
    scale = 1.0
    ch = dim
    for i, (cin, cout) in enumerate(zip(enc_dims[:-1], enc_dims[1:])):
        for j in range(cfg.num_res_blocks):
            blk = [("res", cin, cout)]
            if scale in cfg.attn_scales:
                blk.append(("sattn", cout, cout // hd))
                if cfg.temporal_attention:
                    blk.append(("tattn", cout, cout // hd, cout))
            cin = cout
            input_plan.append(blk)
            skips.append(cout)
            if i != len(cfg.dim_mult) - 1 and j == cfg.num_res_blocks - 1:
                input_plan.append([("down", cout)])
                skips.append(cout)
                scale /= 2.0
        ch = cout

    middle: List[tuple] = [("res", ch, ch), ("sattn", ch, ch // hd)]
    if cfg.temporal_attention:
        middle.append(("tattn", ch, ch // hd, ch))
    middle.append(("res", ch, ch))

    output_plan: List[List[tuple]] = []
    for i, (cin, cout) in enumerate(zip(dec_dims[:-1], dec_dims[1:])):
        for j in range(cfg.num_res_blocks + 1):
            blk = [("res", cin + skips.pop(), cout)]
            if scale in cfg.attn_scales:
                blk.append(("sattn", cout, cout // hd))
                if cfg.temporal_attention:
                    blk.append(("tattn", cout, cout // hd, cout))
            cin = cout
            if i != len(cfg.dim_mult) - 1 and j == cfg.num_res_blocks:
                blk.append(("up", cout))
                scale *= 2.0
            output_plan.append(blk)
    return input_plan, middle, output_plan


# ------------------------------------------------------------------ pieces


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Cos-first, as the repo's timestep_embedding."""
    return timestep_embedding(t, dim)


def _mlp2(p, x):
    """nn.Sequential(Linear, SiLU, Linear)."""
    return F.silu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _temporal_mha(p: Dict[str, Any], x: torch.Tensor, context: torch.Tensor,
                  heads: int) -> torch.Tensor:
    """Self-attention over the frame axis at every pixel of x [B, F, N, C]
    (context is x's normalised self, as the temporal transformers call it):
    projections, then `frame_attention` (B7), then the out projection."""
    if context.shape[:3] != x.shape[:3]:
        raise NotImplementedError("temporal cross-attention over another frame count is on "
                                  "no served path and is not ported")
    wq = p["to_q"]
    d = (wq["q8"] if isinstance(wq, dict) else wq).shape[1] // heads
    q = mmq(x, p["to_q"])
    k = mmq(context, p["to_k"])
    v = mmq(context, p["to_v"])
    out = frame_attention(q, k, v, heads, d ** -0.5)
    return mmq(out, p["out_w"]) + p["out_b"]


def temporal_transformer(p: Dict[str, Any], x: torch.Tensor, heads: int) -> torch.Tensor:
    """TemporalTransformer (use_linear=False, only_self_att=True): GN (stats
    over F, H, W) -> per-frame linear proj_in -> blocks of frame
    self-attention x 2 and GEGLU FF -> proj_out -> residual. x [B, F, H, W, C]."""
    b, f, h, w, c = x.shape
    xn = group_norm(x, p["norm_s"], p["norm_b"])
    y = mmq(xn.reshape(b, f, h * w, c), p["proj_in_w"]) + p["proj_in_b"]
    for blk in p["blocks"]:
        # with context_dim None, attn2 is self-attention too
        yn = layer_norm(y, blk["norm1"])
        y = _temporal_mha(blk["attn1"], yn, yn, heads) + y
        yn = layer_norm(y, blk["norm2"])
        y = _temporal_mha(blk["attn2"], yn, yn, heads) + y
        y = geglu_ff(blk["ff"], layer_norm(y, blk["norm3"])) + y
    y = mmq(y, p["proj_out_w"]) + p["proj_out_b"]
    return y.reshape(b, f, h, w, c) + x


def spatial_transformer_linear(p: Dict[str, Any], x: torch.Tensor, context,
                               heads: int) -> torch.Tensor:
    """SpatialTransformer with use_linear=True: GN (eps 1e-6) -> linear
    proj_in -> blocks over (h w) tokens -> linear proj_out -> residual.
    x [B, H, W, C], context [B, L, ctx]."""
    b, h, w, c = x.shape
    xn = group_norm(x, p["norm_s"], p["norm_b"])
    y = mmq(xn.reshape(b, h * w, c), p["proj_in_w"]) + p["proj_in_b"]
    for blk in p["blocks"]:
        y = basic_transformer_block(blk, y, context, None, heads)
    y = mmq(y, p["proj_out_w"]) + p["proj_out_b"]
    return y.reshape(b, h, w, -1) + x


def _res_block(p, x, emb, eps: float = 1e-5):
    """ResBlock: GN -> SiLU -> conv3x3, + emb, GN -> SiLU -> conv3x3, skip;
    then the built-in temporal conv block. x [B, F, H, W, C]."""
    b, f = x.shape[:2]
    xf = x.reshape((b * f,) + x.shape[2:])
    h = group_norm(xf, p["norm1_s"], p["norm1_b"], eps=eps)
    h = conv2d(F.silu(h), p["conv1_w"], p["conv1_b"], padding=1)
    emb_out = F.silu(emb) @ p["emb_w"] + p["emb_b"]
    h = h + emb_out.to(h.dtype)[:, None, None, :]
    h = group_norm(h, p["norm2_s"], p["norm2_b"], eps=eps)
    h = conv2d(F.silu(h), p["conv2_w"], p["conv2_b"], padding=1)
    skip = conv2d(xf, p["skip_w"], p["skip_b"]) if "skip_w" in p else xf
    h = (skip + h).reshape((b, f) + h.shape[1:])
    return temporal_conv_block(p["tconv"], h)


# ------------------------------------------------------------------ forward


def _run_block(entries, layers, x, emb_bt, ctx_bt):
    """x [B, F, h, w, c]; spatial layers fold F into the batch."""
    b, f = x.shape[:2]

    def fold(x):
        return x.reshape((b * f,) + x.shape[2:])

    def unfold(y):
        return y.reshape((b, f) + y.shape[1:])

    for e, p in zip(entries, layers):
        kind = e[0]
        if kind == "conv_in":
            x = unfold(conv2d(fold(x), p["w"], p["b"], padding=1))
        elif kind == "res":
            x = _res_block(p, x, emb_bt)
        elif kind == "sattn":
            x = unfold(spatial_transformer_linear(p, fold(x), ctx_bt, e[2]))
        elif kind == "tattn":
            x = temporal_transformer(p, x, e[2])
        elif kind == "down":
            x = unfold(conv2d(fold(x), p["w"], p["b"], stride=2, padding=1))
        elif kind == "up":
            x = unfold(conv2d(upsample2x_nearest(fold(x)), p["w"], p["b"], padding=1))
    return x


def forward(params: Dict[str, Any], cfg: UNetSDVideoConfig, x: torch.Tensor, t: torch.Tensor,
            y: Optional[torch.Tensor] = None, fps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, F, H, W, in_dim] latents; t / fps [B]; y [B, L, context_dim]
    text tokens (None -> params['zero_y'][:, :1]). Returns [B, F, H, W,
    out_dim]. The t2v variant (unet_t2v.py:210-277)."""
    if cfg.variant != "t2v":
        raise NotImplementedError(f"the {cfg.variant!r} video UNet is not ported yet (task G, "
                                  "ROADMAP A11)")
    b, f = x.shape[:2]
    dtype = x.dtype
    emb = _mlp2(params["time_embed"], sinusoidal_embedding(t, cfg.dim).to(dtype))
    if cfg.use_fps_condition and fps is not None:
        emb = emb + _mlp2(params["fps_embed"], sinusoidal_embedding(fps, cfg.dim).to(dtype))
    emb_bt = emb.repeat_interleave(f, dim=0)  # (b f) ordering, b-major
    if y is None:
        y = params["zero_y"][:, :1].expand(b, 1, cfg.context_dim)
    ctx_bt = y.to(dtype).repeat_interleave(f, dim=0)

    input_plan, middle_plan, output_plan = block_plan(cfg)
    hs = []
    h = x
    for entries, layers in zip(input_plan, params["input_blocks"]):
        h = _run_block(entries, layers, h, emb_bt, ctx_bt)
        hs.append(h)
    h = _run_block(middle_plan, params["middle_block"], h, emb_bt, ctx_bt)
    for entries, layers in zip(output_plan, params["output_blocks"]):
        h = torch.cat([h, hs.pop()], dim=-1)
        h = _run_block(entries, layers, h, emb_bt, ctx_bt)

    yf = h.reshape((b * f,) + h.shape[2:])
    yf = group_norm(yf, params["out_norm_s"], params["out_norm_b"], eps=1e-5)
    yf = conv2d(F.silu(yf), params["out_w"], params["out_b"], padding=1)
    return yf.reshape((b, f) + yf.shape[1:])


# ------------------------------------------------------------------ init


def init_params(gen: torch.Generator, cfg: UNetSDVideoConfig, device) -> Dict[str, Any]:
    """Random float32 t2v params with the JAX init's keys, shapes, scales and
    zero leaves (each tconv block's conv3_w, every res block's conv2_w,
    every proj_out_w, the out conv, fps_embed's last layer and the biases):
    drawn on `device`, so a full-width UNet is made on the card."""
    if cfg.variant != "t2v":
        raise NotImplementedError(f"the {cfg.variant!r} video UNet is not ported yet")
    f32 = torch.float32
    ed = cfg.embed_dim

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=f32, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    def ones(n):
        return torch.ones((n,), dtype=f32, device=device)

    def conv(kh, cin, cout, zero=False):
        return zeros(kh, kh, cin, cout) if zero else randn(kh, kh, cin, cout) / math.sqrt(
            kh * kh * cin)

    def lin(cin, cout, zero=False):
        return zeros(cin, cout) if zero else randn(cin, cout) / math.sqrt(cin)

    def mlp2(cin, cmid, cout, zero_last=False):
        return {"w1": lin(cin, cmid), "b1": zeros(cmid), "w2": lin(cmid, cout, zero=zero_last),
                "b2": zeros(cout)}

    def ln(c):
        return {"scale": ones(c), "bias": zeros(c)}

    def attn(qdim, kdim, inner):
        return {"to_q": lin(qdim, inner), "to_k": lin(kdim, inner), "to_v": lin(kdim, inner),
                "out_w": lin(inner, qdim), "out_b": zeros(qdim)}

    def tblock(d, ctx):
        return {"attn1": attn(d, d, d), "attn2": attn(d, ctx if ctx else d, d),
                "ff": {"proj_w": lin(d, d * 8), "proj_b": zeros(d * 8),
                       "out_w": lin(d * 4, d), "out_b": zeros(d)},
                "norm1": ln(d), "norm2": ln(d), "norm3": ln(d)}

    def tconv(c):
        p = {}
        for i in range(4):
            p[f"norm{i}_s"] = ones(c)
            p[f"norm{i}_b"] = zeros(c)
            p[f"conv{i}_w"] = zeros(3, 1, c, c) if i == 3 else randn(3, 1, c, c) / math.sqrt(
                3 * c)
            p[f"conv{i}_b"] = zeros(c)
        return p

    def transformer(ch, inner, ctx):
        return {"norm_s": ones(ch), "norm_b": zeros(ch), "proj_in_w": lin(ch, inner),
                "proj_in_b": zeros(inner), "proj_out_w": lin(inner, ch, zero=True),
                "proj_out_b": zeros(ch), "blocks": [tblock(inner, ctx)]}

    def build(e):
        if e[0] == "conv_in":
            return {"w": conv(3, e[1], e[2]), "b": zeros(e[2])}
        if e[0] == "res":
            cin, cout = e[1], e[2]
            p = {"norm1_s": ones(cin), "norm1_b": zeros(cin), "conv1_w": conv(3, cin, cout),
                 "conv1_b": zeros(cout), "emb_w": lin(ed, cout), "emb_b": zeros(cout),
                 "norm2_s": ones(cout), "norm2_b": zeros(cout),
                 "conv2_w": conv(3, cout, cout, zero=True), "conv2_b": zeros(cout),
                 "tconv": tconv(cout)}
            if cin != cout:
                p["skip_w"] = conv(1, cin, cout)
                p["skip_b"] = zeros(cout)
            return p
        if e[0] == "sattn":
            return transformer(e[1], e[2] * cfg.head_dim, cfg.context_dim)
        if e[0] == "tattn":
            return transformer(e[1], e[3], None)
        if e[0] in ("down", "up"):
            return {"w": conv(3, e[1], e[1]), "b": zeros(e[1])}
        raise ValueError(e[0])

    input_plan, middle_plan, output_plan = block_plan(cfg)
    params: Dict[str, Any] = {
        "time_embed": mlp2(cfg.dim, ed, ed),
        "input_blocks": [[build(e) for e in blk] for blk in input_plan],
        "middle_block": [build(e) for e in middle_plan],
        "output_blocks": [[build(e) for e in blk] for blk in output_plan],
        "out_norm_s": ones(cfg.dim), "out_norm_b": zeros(cfg.dim),
        "out_w": conv(3, cfg.dim, cfg.out_dim, zero=True), "out_b": zeros(cfg.out_dim),
    }
    if cfg.use_fps_condition:
        params["fps_embed"] = mlp2(cfg.dim, ed, ed, zero_last=True)
    return params
