"""The video UNets: ZeroScope / T2V (UNetSD_T2VBase) and I2VGen-XL (UNetSD_I2VGen).

Port of `vitron_tpu/models/diffusion/unet_sd_video.py`: `UNetSDVideoConfig`
(:61-115), `block_plan` (:118-173), the pieces (:178-374), `_run_block` and
`forward` (:379-494) and `init_params` (:511-627). Activations are
[B, F, H, W, C] as in JAX; spatial layers fold the frames into the batch,
temporal layers see per-pixel frame sequences. Three kernels sit under it on
CUDA tensors, besides the group-norm sums (B8) of every norm:
- every res block ends in `video_unet.temporal_conv_block` (B6, the
  temporal k=3 conv, four times);
- every temporal transformer's two frame self-attentions go to
  `kernels.temporal_attention.frame_attention` (B7), in float32 and bf16;
- every transformer's feed-forward is `layers.geglu_ff` (B3).
The t2v spatial attention sites have 720, 180 and 45 tokens at 320x576,
under `VITRON_FLASH_MIN`, so they stay on `layers._mha`'s einsum path, as in
JAX. At the i2vgen variant's 64x64 latents the 32x32 level's
self-attention has 1024 tokens and `_mha` sends it to the flash kernel (B2,
D 64); its cross-attention has 145 keys and stays on the einsum path.

The i2vgen variant (task G) adds the fps embedding (always on) and three
image streams: the first-frame concat stream (three convs over the latent
and the frame-position maps, `transformer_v2` over each pixel's frames,
added twice as upstream does), 64 local-image context tokens (a conv, an
adaptive pool to 32x32, two stride-2 convs) and `num_tokens` global
tokens from the image embedding, for a context of 77 + 64 + 4 tokens.

`convert_torch` (:730-896) reads a reference UNetSD_T2VBase / UNetSD_I2VGen
state dict into the param tree (its transformer blocks are the SD UNet's
without a fuser: `layers.convert_transformer_block`). `quantize_params` (W8A8:
the 3x3 convs to int8 for Q2, and on request the transformer products and
the temporal taps) serves it under `VITRON_VUNET_QUANT=w8a8`
(`quant_default`). The TPU layout experiment `_temporal_mha_nmajor`
(`VITRON_TATTN=nmajor`), which computes the same function as the default
path, is not ported.

Under `distributed/video_sharding.shard_video_step` a rank runs `forward` on
its (cfg, frames) block of the latent: the temporal conv, the (F, H, W)
group norms and the frame attention then exchange frames with the rest of
the frames group (that module's docstring), and the i2vgen image streams
give each frame its global position and run their adapter transformer on
the gathered frames.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from vitron_tpu_torch.core.mesh import all_gather
from vitron_tpu_torch.distributed.video_sharding import (frame_attention, frames_group,
                                                         local_frames)
from vitron_tpu_torch.kernels.quantization import matmul_maybe_quantized as mmq
from vitron_tpu_torch.models.diffusion import unet2d
from vitron_tpu_torch.models.diffusion.layers import (basic_transformer_block, conv2d, conv_w,
                                                      convert_ln, convert_transformer_block,
                                                      geglu_ff, group_norm, layer_norm, layout,
                                                      lin_w, reading, timestep_embedding,
                                                      upsample2x_nearest)
from vitron_tpu_torch.models.diffusion.video_unet import temporal_conv_block


@dataclasses.dataclass(frozen=True)
class UNetSDVideoConfig:
    """The JAX config, field for field; y_dim, num_tokens,
    adapter_transformer_layers and concat_dim are read only by the i2vgen
    variant."""

    variant: str = "t2v"                      # "t2v" | "i2vgen"
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
        # unet_i2vgen.py:82 overrides the concat_dim argument with in_dim
        return self.in_dim

    @property
    def embed_dim(self) -> int:
        return self.dim * 4

    @staticmethod
    def i2vgen_xl(**kw) -> "UNetSDVideoConfig":
        """configs/i2vgen_xl_train.yaml:32-51 (dim keeps the default)."""
        base = dict(variant="i2vgen", in_dim=4, y_dim=1024, context_dim=1024, out_dim=4,
                    dim_mult=(1, 2, 4, 4), num_heads=8, head_dim=64, num_res_blocks=2)
        base.update(kw)
        return UNetSDVideoConfig(**base)

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


def block_plan_hw(cfg: UNetSDVideoConfig, lh: int, lw: int):
    """(entry, latent height, width at that entry) for every entry of
    `block_plan` at an lh x lw latent ('down' at its output size, 'up' at
    its input size)."""
    h, w = lh, lw
    input_plan, middle_plan, output_plan = block_plan(cfg)
    for entries in input_plan + [middle_plan] + output_plan:
        for e in entries:
            if e[0] == "down":
                h, w = (h + 1) // 2, (w + 1) // 2
            yield e, h, w
            if e[0] == "up":
                h, w = 2 * h, 2 * w


def conv3x3_sites(cfg: UNetSDVideoConfig, lh: int, lw: int) -> collections.Counter:
    """(H, W, C, D) of every stride-1 3x3 conv of one UNet call at an lh x lw
    latent, with its count: conv_in, each res block's two, each upsampling's
    (at the doubled size) and the out conv. The stride-2 downs and the
    i2vgen image streams' narrow convs (4 to 16 wide) are left out."""
    sites = collections.Counter({(lh, lw, cfg.dim, cfg.out_dim): 1})
    for e, h, w in block_plan_hw(cfg, lh, lw):
        if e[0] == "conv_in":
            sites[(h, w, e[1], e[2])] += 1
        elif e[0] == "res":
            sites[(h, w, e[1], e[2])] += 1
            sites[(h, w, e[2], e[2])] += 1
        elif e[0] == "up":
            sites[(2 * h, 2 * w, e[1], e[1])] += 1
    return sites


# ------------------------------------------------------------------ pieces


def sinusoidal_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Cos-first, as the repo's timestep_embedding."""
    return timestep_embedding(t, dim)


def _mlp2(p, x):
    """nn.Sequential(Linear, SiLU, Linear)."""
    return F.silu(x @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def adaptive_avg_pool2d(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """torch's AdaptiveAvgPool2d on NHWC x: output bin i of an axis of n
    averages [floor(i n / out), ceil((i + 1) n / out)), the JAX integral-image
    form's bins, also when out > n (overlapping bins). Where each side
    divides by its output side the bins are equal windows, pooled by
    `avg_pool2d` at kernel = stride: its CUDA backward is deterministic,
    adaptive pooling's is not (ROADMAP C15)."""
    (h, w), (oh, ow) = x.shape[1:3], out_hw
    xc = x.permute(0, 3, 1, 2)
    if h % oh == 0 and w % ow == 0:
        y = F.avg_pool2d(xc, (h // oh, w // ow))
    else:
        y = F.adaptive_avg_pool2d(xc, out_hw)
    return y.permute(0, 2, 3, 1)


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
    xn = group_norm(x, p["norm_s"], p["norm_b"], frames=frames_group())
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


def transformer_v2(layers_p, x: torch.Tensor, heads: int, dim_head: int) -> torch.Tensor:
    """TransformerV2 (util.py:1129-1148) on x [S, N, C]: PreNorm attention
    (+x), then a plain FeedForward (Linear-GELU(erf)-Linear) with its own
    residual and no pre-norm. The attention is an einsum over all S
    sequences at once (8192 of 16 frames at full width)."""
    for lp in layers_p:
        q, k, v = (layer_norm(x, lp["norm"]) @ lp["qkv_w"]).chunk(3, dim=-1)
        b, n, inner = q.shape
        q, k, v = (a.reshape(b, n, heads, dim_head) for a in (q, k, v))
        sim = torch.einsum("bnhd,bmhd->bhnm", q, k).to(torch.float32) * dim_head ** -0.5
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, inner)
        x = out @ lp["out_w"] + lp["out_b"] + x
        x = F.gelu(x @ lp["ff_w1"] + lp["ff_b1"]) @ lp["ff_w2"] + lp["ff_b2"] + x
    return x


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


def _image_streams(params, cfg: UNetSDVideoConfig, x, f: int, ctx, image, local_image):
    """The i2vgen conditioning (unet_i2vgen.py:280-325): x [B, F, H, W,
    in_dim] with the first-frame concat stream appended on channels, and the
    context with the 64 local-image tokens and the global tokens appended."""
    b, _, h, w, _ = x.shape
    dtype = x.dtype
    fg = frames_group()  # x holds frames [first, first + f) of `total`
    first, total = (fg.index * f, fg.size * f) if fg is not None else (0, f)
    li = local_image.to(dtype)                              # [B, H, W, 4]
    # frame 0 = the latent; frame k = the constant k / (total - 1)
    frame = torch.arange(first, first + f, device=x.device)
    pos = frame.to(dtype) / max(total - 1, 1)
    xi = torch.where((frame == 0)[None, :, None, None, None], li[:, None],
                     pos[None, :, None, None, None].expand(b, f, h, w, li.shape[-1]))
    xi = xi.reshape((b * f,) + xi.shape[2:])
    cp = params["local_concat"]
    xi = conv2d(xi, cp["conv0_w"], cp["conv0_b"], padding=1)
    xi = conv2d(F.silu(xi), cp["conv1_w"], cp["conv1_b"], padding=1)
    xi = conv2d(F.silu(xi), cp["conv2_w"], cp["conv2_b"], padding=1)
    cd = xi.shape[-1]
    # (b h w) sequences of f frames for the adapter transformer
    tok = xi.reshape(b, f, h, w, cd).permute(0, 2, 3, 1, 4).reshape(b * h * w, f, cd)
    if fg is not None:  # the adapter attends over every frame of the video
        tok = local_frames(transformer_v2(params["local_temporal"],
                                          all_gather(tok, fg.group, dim=1), heads=2,
                                          dim_head=cd), fg)
    else:
        tok = transformer_v2(params["local_temporal"], tok, heads=2, dim_head=cd)
    concat = tok.reshape(b, h, w, f, cd).permute(0, 3, 1, 2, 4) * 2.0  # added twice upstream
    x = torch.cat([x, concat.to(dtype)], dim=-1)

    lp = params["local_embed"]
    lc = conv2d(li, lp["conv0_w"], lp["conv0_b"], padding=1)
    lc = adaptive_avg_pool2d(F.silu(lc), (32, 32))
    lc = conv2d(lc, lp["conv1_w"], lp["conv1_b"], stride=2, padding=1)
    lc = conv2d(F.silu(lc), lp["conv2_w"], lp["conv2_b"], stride=2, padding=1)
    ctx = torch.cat([ctx, lc.reshape(b, -1, lc.shape[-1])], dim=1)   # + [B, 64, ctx]
    if image is not None:
        ic = _mlp2(params["context_embed"], image.to(dtype))
        ctx = torch.cat([ctx, ic.reshape(b, cfg.num_tokens, cfg.context_dim)], dim=1)
    return x, ctx


def _per_frame(x: torch.Tensor, f: int) -> torch.Tensor:
    """[B, ...] -> [B F, ...], each row repeated f times (b-major): an
    expand, whose gradient is a sum (repeat_interleave's scatter-adds would
    not give the same bits twice on the card)."""
    return x[:, None].expand(x.shape[0], f, *x.shape[1:]).reshape(x.shape[0] * f, *x.shape[1:])


def forward(params: Dict[str, Any], cfg: UNetSDVideoConfig, x: torch.Tensor, t: torch.Tensor,
            y: Optional[torch.Tensor] = None, fps: Optional[torch.Tensor] = None,
            image: Optional[torch.Tensor] = None,
            local_image: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, F, H, W, in_dim] latents; t / fps [B]; y [B, L, context_dim]
    text tokens (None -> params['zero_y'][:, :1]); i2vgen only: image
    [B, y_dim] global image embedding (None: no global tokens) and
    local_image [B, H, W, in_dim] first-frame latent. Returns [B, F, H, W,
    out_dim] (unet_i2vgen.py:243-346 / unet_t2v.py:210-277)."""
    if cfg.variant not in ("t2v", "i2vgen"):
        raise ValueError(f"unknown video UNet variant {cfg.variant!r}")
    b, f = x.shape[:2]
    dtype = x.dtype
    emb = _mlp2(params["time_embed"], sinusoidal_embedding(t, cfg.dim).to(dtype))
    if cfg.variant == "i2vgen" or (cfg.use_fps_condition and fps is not None):
        emb = emb + _mlp2(params["fps_embed"], sinusoidal_embedding(fps, cfg.dim).to(dtype))
    emb_bt = _per_frame(emb, f)  # (b f) ordering, b-major
    if y is None:
        y = params["zero_y"][:, :1].expand(b, 1, cfg.context_dim)
    ctx = y.to(dtype)
    if cfg.variant == "i2vgen":
        x, ctx = _image_streams(params, cfg, x, f, ctx, image, local_image)
    ctx_bt = _per_frame(ctx, f)

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
    """Random float32 params with the JAX init's keys, shapes, scales and
    zero leaves (each tconv block's conv3_w, every res block's conv2_w,
    every proj_out_w, the out conv, fps_embed's last layer and the biases),
    with the i2vgen variant's image streams: drawn on `device`, so a
    full-width UNet is made on the card."""
    if cfg.variant not in ("t2v", "i2vgen"):
        raise ValueError(f"unknown video UNet variant {cfg.variant!r}")
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
    if cfg.variant == "i2vgen" or cfg.use_fps_condition:
        params["fps_embed"] = mlp2(cfg.dim, ed, ed, zero_last=True)
    if cfg.variant == "i2vgen":
        cd, inner = cfg.concat_dim, 2 * cfg.concat_dim
        params["context_embed"] = mlp2(cfg.y_dim, ed, cfg.context_dim * cfg.num_tokens)
        params["local_concat"] = {
            "conv0_w": conv(3, 4, cd * 4), "conv0_b": zeros(cd * 4),
            "conv1_w": conv(3, cd * 4, cd * 4), "conv1_b": zeros(cd * 4),
            "conv2_w": conv(3, cd * 4, cd), "conv2_b": zeros(cd)}
        params["local_temporal"] = [
            {"norm": ln(cd), "qkv_w": lin(cd, inner * 3), "out_w": lin(inner, cd),
             "out_b": zeros(cd), "ff_w1": lin(cd, cd * 4), "ff_b1": zeros(cd * 4),
             "ff_w2": lin(cd * 4, cd), "ff_b2": zeros(cd)}
            for _ in range(cfg.adapter_transformer_layers)]
        # upstream hardcodes 1024 output channels (unet_i2vgen.py:132),
        # context_dim in every shipped config
        params["local_embed"] = {
            "conv0_w": conv(3, 4, cd * 8), "conv0_b": zeros(cd * 8),
            "conv1_w": conv(3, cd * 8, cd * 16), "conv1_b": zeros(cd * 16),
            "conv2_w": conv(3, cd * 16, cfg.context_dim), "conv2_b": zeros(cfg.context_dim)}
    return params


# ----------------------------------------------------------- quantization

_QUANT_DOT_KEYS = frozenset((
    "to_q", "to_k", "to_v", "out_w",     # spatial/temporal attention
    "proj_w",                            # GEGLU FF up-projection
    "proj_in_w", "proj_out_w",           # transformer in/out projections
))


def quantize_params(params: Dict[str, Any], min_channels: int = 64,
                    min_dot_dim: Optional[int] = None,
                    min_tconv_dim: Optional[int] = None) -> Dict[str, Any]:
    """W8A8 serving quantization of a video UNet, spatial convs only by
    default: every floating [3, 3, ci, co] leaf with ci, co >= min_channels
    becomes the {"qc", "s"} dict `layers.conv2d` sends to Q2. Two more
    classes, as in JAX, only when asked for: the transformer products of
    `_QUANT_DOT_KEYS` with both dims >= min_dot_dim ({"q8", "s"}, the
    per-row W8A8 dot) and the temporal conv taps [3, 1, c, co] with dims >=
    min_tconv_dim ({"q8t", "s"}). The rest (conv_in and out, the embedding
    MLPs, the norms) stays as it is. Applying it twice changes nothing (the
    int8 leaves are not floating, and a quantized dict is kept whole).
    Inference only; `VITRON_VUNET_QUANT=w8a8` (`quant_default`) opts the
    video pipelines in."""
    from vitron_tpu_torch.kernels.quantization import (quantize_conv2d, quantize_int8_a8,
                                                       quantize_tconv)

    def floating(v) -> bool:
        return torch.is_tensor(v) and v.is_floating_point()

    def conv_eligible(v) -> bool:
        return (floating(v) and v.dim() == 4 and v.shape[0] == 3 and v.shape[1] == 3
                and v.shape[2] >= min_channels and v.shape[3] >= min_channels)

    def dot_eligible(k, v) -> bool:
        return (min_dot_dim is not None and k in _QUANT_DOT_KEYS and floating(v)
                and v.dim() == 2 and min(v.shape) >= min_dot_dim)

    def tconv_eligible(v) -> bool:
        return (min_tconv_dim is not None and floating(v) and v.dim() == 4
                and v.shape[0] == 3 and v.shape[1] == 1
                and v.shape[2] >= min_tconv_dim and v.shape[3] >= min_tconv_dim)

    def walk(p):
        if isinstance(p, dict):
            if ("qc" in p or "q8" in p or "q8t" in p) and "s" in p:
                return p
            return {k: (quantize_conv2d(v) if conv_eligible(v)
                        else quantize_int8_a8(v) if dot_eligible(k, v)
                        else quantize_tconv(v) if tconv_eligible(v)
                        else walk(v))
                    for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v) for v in p)
        return p

    return walk(params)


def quant_default() -> bool:
    """VITRON_VUNET_QUANT=w8a8 opts serving into the quantized video UNet."""
    return os.environ.get("VITRON_VUNET_QUANT", "") == "w8a8"


# ------------------------------------------------------------------ convert


def _convert_tconv(sd, pfx):
    """TemporalConvBlock_v2: conv1 = Seq(GN, SiLU, Conv3d), conv2..4 =
    Seq(GN, SiLU, Dropout, Conv3d), each Conv3d (3, 1, 1). The caller's key
    carries upstream's attribute typo 'temopral_conv'."""
    p = {}
    for i in range(4):
        seq = f"conv{i + 1}"
        conv_idx = 2 if i == 0 else 3
        p[f"norm{i}_s"] = sd[f"{pfx}{seq}.0.weight"]
        p[f"norm{i}_b"] = sd[f"{pfx}{seq}.0.bias"]
        p[f"conv{i}_w"] = layout(sd[f"{pfx}{seq}.{conv_idx}.weight"], "conv3d_t")
        p[f"conv{i}_b"] = sd[f"{pfx}{seq}.{conv_idx}.bias"]
    return p


def _convert_res(sd, pfx):
    """The SD UNet's ResBlock keys plus the temporal conv block."""
    return {**unet2d._convert_res(sd, pfx), "tconv": _convert_tconv(sd, pfx + "temopral_conv.")}


def _convert_transformer(sd, pfx, proj: str):
    """A SpatialTransformer (use_linear=True: proj_in/out Linear, `proj`
    "linear") or a TemporalTransformer (use_linear=False: k=1 Conv1d,
    "conv1d"), one block without a fuser."""
    return {"norm_s": sd[pfx + "norm.weight"],
            "norm_b": sd[pfx + "norm.bias"],
            "proj_in_w": layout(sd[pfx + "proj_in.weight"], proj),
            "proj_in_b": sd[pfx + "proj_in.bias"],
            "proj_out_w": layout(sd[pfx + "proj_out.weight"], proj),
            "proj_out_b": sd[pfx + "proj_out.bias"],
            "blocks": [convert_transformer_block(sd, pfx + "transformer_blocks.0.",
                                                 with_fuser=False)]}


def _convert_mlp2(sd, pfx):
    return {"w1": lin_w(sd, pfx + "0.weight"), "b1": sd[pfx + "0.bias"],
            "w2": lin_w(sd, pfx + "2.weight"), "b2": sd[pfx + "2.bias"]}


def convert_torch(sd, cfg: UNetSDVideoConfig, device="cpu") -> Dict[str, Any]:
    """Reference UNetSD_T2VBase / UNetSD_I2VGen state dict -> param tree on
    `device`, walking `cfg`'s block plan; fps_embedding where the dict has it.
    Accepts raw state dicts or checkpoint dicts whose keys carry a leading
    'module.' (DDP) prefix."""
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    sd = reading(sd, device)

    def convert_entry(e, pfx):
        if e[0] == "conv_in":
            return {"w": conv_w(sd, pfx + "weight"), "b": sd[pfx + "bias"]}
        if e[0] == "res":
            return _convert_res(sd, pfx)
        if e[0] == "sattn":
            return _convert_transformer(sd, pfx, "linear")
        if e[0] == "tattn":
            return _convert_transformer(sd, pfx, "conv1d")
        if e[0] == "down":
            return {"w": conv_w(sd, pfx + "op.weight"), "b": sd[pfx + "op.bias"]}
        if e[0] == "up":
            return {"w": conv_w(sd, pfx + "conv.weight"), "b": sd[pfx + "conv.bias"]}
        raise ValueError(e[0])

    input_plan, middle_plan, output_plan = block_plan(cfg)
    params: Dict[str, Any] = {
        "time_embed": _convert_mlp2(sd, "time_embed."),
        # Downsample blocks are appended bare, not wrapped in a ModuleList,
        # so they have no inner index in the state dict
        "input_blocks": [
            [convert_entry(e, f"input_blocks.{i}." if e[0] == "down"
                           else f"input_blocks.{i}.{j}.")
             for j, e in enumerate(blk)]
            for i, blk in enumerate(input_plan)],
        "middle_block": [convert_entry(e, f"middle_block.{j}.")
                         for j, e in enumerate(middle_plan)],
        "output_blocks": [
            [convert_entry(e, f"output_blocks.{i}.{j}.") for j, e in enumerate(blk)]
            for i, blk in enumerate(output_plan)],
        "out_norm_s": sd["out.0.weight"], "out_norm_b": sd["out.0.bias"],
        "out_w": conv_w(sd, "out.2.weight"), "out_b": sd["out.2.bias"],
    }
    if "fps_embedding.0.weight" in sd:
        params["fps_embed"] = _convert_mlp2(sd, "fps_embedding.")
    if cfg.variant == "i2vgen":
        params["context_embed"] = _convert_mlp2(sd, "context_embedding.")
        params["local_concat"] = {
            "conv0_w": conv_w(sd, "local_image_concat.0.weight"),
            "conv0_b": sd["local_image_concat.0.bias"],
            "conv1_w": conv_w(sd, "local_image_concat.2.weight"),
            "conv1_b": sd["local_image_concat.2.bias"],
            "conv2_w": conv_w(sd, "local_image_concat.4.weight"),
            "conv2_b": sd["local_image_concat.4.bias"],
        }
        params["local_temporal"] = []
        for i in range(cfg.adapter_transformer_layers):
            base = f"local_temporal_encoder.layers.{i}."
            params["local_temporal"].append({
                "norm": convert_ln(sd, base + "0.norm."),
                "qkv_w": lin_w(sd, base + "0.fn.to_qkv.weight"),
                "out_w": lin_w(sd, base + "0.fn.to_out.0.weight"),
                "out_b": sd[base + "0.fn.to_out.0.bias"],
                "ff_w1": lin_w(sd, base + "1.net.0.0.weight"),
                "ff_b1": sd[base + "1.net.0.0.bias"],
                "ff_w2": lin_w(sd, base + "1.net.2.weight"),
                "ff_b2": sd[base + "1.net.2.bias"],
            })
        # Sequential(conv, SiLU, AdaptiveAvgPool2d, conv, SiLU, conv): 0, 3, 5
        params["local_embed"] = {
            "conv0_w": conv_w(sd, "local_image_embedding.0.weight"),
            "conv0_b": sd["local_image_embedding.0.bias"],
            "conv1_w": conv_w(sd, "local_image_embedding.3.weight"),
            "conv1_b": sd["local_image_embedding.3.bias"],
            "conv2_w": conv_w(sd, "local_image_embedding.5.weight"),
            "conv2_b": sd["local_image_embedding.5.bias"],
        }
    return params
