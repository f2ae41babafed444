"""Shared latent-diffusion building blocks.

Port of `vitron_tpu/models/diffusion/layers.py` (:30-331): functional
params-in / activations-out, NHWC activations and HWIO conv weights as in
the JAX package. Three kernels sit under these layers on CUDA tensors:
`group_norm` takes its sums from `kernels.group_norm.group_norm_sums`,
`geglu_ff` is `kernels.geglu_ff.geglu_ff`, and `_mha` sends attention sites
of at least `VITRON_FLASH_MIN` (1024) query and key tokens to
`kernels.flash_attention` (non-causal, shift 0, bf16 q/k/v), as the JAX
package does on the TPU. CPU tensors take the same code with the kernels'
plain versions and the einsum attention path.

The checkpoint converters (:334-469) wait for the loaders (ROADMAP A7) and
`position_net_with_image` for the style pipeline.
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from vitron_tpu_torch.kernels import flash_attention as _fa
from vitron_tpu_torch.kernels import geglu_ff as _gf
from vitron_tpu_torch.kernels.group_norm import group_norm_sums
from vitron_tpu_torch.kernels.quantization import matmul_maybe_quantized

# ---------------------------------------------------------------- primitives


def group_norm(x: torch.Tensor, scale, bias, groups: int = 32, eps: float = 1e-6) -> torch.Tensor:
    """x [B, ..., C]: normalise over the spatial dims and each group of C/G
    channels, from float32 (sum, sum of squares) per (sample, channel)."""
    b, c = x.shape[0], x.shape[-1]
    n = math.prod(x.shape[1:-1]) * (c // groups)
    st = group_norm_sums(x.reshape(b, -1, c).contiguous())
    g1 = st[:, 0].reshape(b, groups, c // groups).sum(-1)
    g2 = st[:, 1].reshape(b, groups, c // groups).sum(-1)
    mu = g1 / n
    inv = torch.rsqrt(g2 / n - mu * mu + eps)
    invc = inv.repeat_interleave(c // groups, dim=-1)  # [B, C]
    muc = mu.repeat_interleave(c // groups, dim=-1)
    a = invc * scale.to(torch.float32)
    d = bias.to(torch.float32) - muc * a
    bshape = (b,) + (1,) * (x.dim() - 2) + (c,)
    return (x.to(torch.float32) * a.reshape(bshape) + d.reshape(bshape)).to(x.dtype)


def layer_norm(x, p, eps: float = 1e-5):
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


def conv2d(x: torch.Tensor, w, b: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x [B, H, W, C_in] @ w [kh, kw, C_in, C_out] (HWIO), weights cast to
    x.dtype. 1x1 stride-1 convs are matmuls; the rest run in the
    channels-last layout, so the NHWC tensor is neither copied in nor out."""
    if isinstance(w, dict):
        raise NotImplementedError("quantized conv weights (W8A8) are not ported yet "
                                  "(ROADMAP A17)")
    if w.shape[0] == w.shape[1] == 1 and stride == 1 and padding == 0:
        out = x @ w[0, 0].to(x.dtype)
        return out if b is None else out + b.to(out.dtype)
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                   None if b is None else b.to(x.dtype), stride=stride, padding=padding)
    return out.permute(0, 2, 3, 1)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, 2H, 2W, C] nearest."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """[B] -> [B, dim] float32; cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].to(torch.float32) * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def fourier_embed(x: torch.Tensor, num_freqs: int = 8, temperature: float = 100.0) -> torch.Tensor:
    """GLIGEN FourierEmbedder: [..., D] -> [..., 2*F*D], sin/cos per band."""
    bands = temperature ** (torch.arange(num_freqs, dtype=torch.float32, device=x.device)
                            / num_freqs)
    out = []
    for i in range(num_freqs):
        out.append(torch.sin(bands[i] * x))
        out.append(torch.cos(bands[i] * x))
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------- attention


def _flash_min() -> int:
    """Attention sites below this many query or key tokens stay on the
    einsum path (the JAX package's threshold and knob). Read per call."""
    return int(os.environ.get("VITRON_FLASH_MIN", "1024"))


def _mha(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """q [B, N, H*C]; k/v [B, M, H*C] -> [B, N, H*C], float32 softmax."""
    b, n, hc = q.shape
    m = k.shape[1]
    c = hc // heads
    q = q.reshape(b, n, heads, c)
    k = k.reshape(b, m, heads, c)
    v = v.reshape(b, m, heads, c)
    fmin = _flash_min()
    if n >= fmin and m >= fmin and q.device.type == "cuda":
        bf16 = torch.bfloat16
        out = _fa.flash_attention(q.to(bf16).contiguous(), k.to(bf16).contiguous(),
                                  v.to(bf16).contiguous(), scale=float(scale), causal=False,
                                  softmax_shift=0.0)
        return out.to(v.dtype).reshape(b, n, hc)
    sim = torch.einsum("bnhc,bmhc->bhnm", q, k).to(torch.float32) * scale
    if v.dtype == torch.bfloat16:
        # bf16 probabilities, normalised after the (small) attn @ v product
        p = torch.exp(sim - sim.amax(dim=-1, keepdim=True))
        s = p.sum(dim=-1)  # [B, H, N]
        out = torch.einsum("bhnm,bmhc->bnhc", p.to(torch.bfloat16), v)
        out = out.to(torch.float32) / s.permute(0, 2, 1)[..., None]
        return out.to(v.dtype).reshape(b, n, hc)
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhc->bnhc", attn, v).reshape(b, n, hc)


def cross_attention(p: Dict[str, Any], x, context, heads: int) -> torch.Tensor:
    """q from x, k/v from context, no biases; out projection with bias."""
    wq = p["to_q"]
    c = (wq["q8"] if isinstance(wq, dict) else wq).shape[1] // heads
    q = matmul_maybe_quantized(x, wq)
    k = matmul_maybe_quantized(context, p["to_k"])
    v = matmul_maybe_quantized(context, p["to_v"])
    out = _mha(q, k, v, heads, c ** -0.5)
    return matmul_maybe_quantized(out, p["out_w"]) + p["out_b"]


def self_attention(p: Dict[str, Any], x, heads: int) -> torch.Tensor:
    return cross_attention(p, x, x, heads)


def geglu_ff(p: Dict[str, Any], x) -> torch.Tensor:
    """FeedForward with GEGLU: the fused kernel on CUDA, its plain version
    (the same arithmetic as the JAX XLA form) on the CPU."""
    if isinstance(p["proj_w"], dict):
        raise NotImplementedError("quantized feed-forward weights (W8A8) are not ported "
                                  "yet (ROADMAP A17)")
    return _gf.geglu_ff(x, p["proj_w"], p["proj_b"], p["out_w"], p["out_b"])


def gated_self_attention(p: Dict[str, Any], x, objs, heads: int, gate_scale=1.0) -> torch.Tensor:
    """GLIGEN GatedSelfAttentionDense: concat visual + grounding tokens,
    self-attend, keep the visual slice, add through tanh(alpha) gates scaled
    by the scheduled `gate_scale`."""
    n_visual = x.shape[1]
    objs_p = objs @ p["linear_w"] + p["linear_b"]
    cat = torch.cat([x, objs_p], dim=1)
    attn_out = self_attention(p["attn"], layer_norm(cat, p["norm1"]), heads)
    x = x + gate_scale * torch.tanh(p["alpha_attn"]) * attn_out[:, :n_visual]
    return x + gate_scale * torch.tanh(p["alpha_dense"]) * geglu_ff(
        p["ff"], layer_norm(x, p["norm2"]))


def basic_transformer_block(p: Dict[str, Any], x, context, objs, heads: int,
                            gate_scale=1.0) -> torch.Tensor:
    """self-attn -> GLIGEN fuser -> cross-attn -> GEGLU FF, pre-LN residuals."""
    x = self_attention(p["attn1"], layer_norm(x, p["norm1"]), heads) + x
    if "fuser" in p and objs is not None:
        x = gated_self_attention(p["fuser"], x, objs, heads, gate_scale)
    x = cross_attention(p["attn2"], layer_norm(x, p["norm2"]), context, heads) + x
    return geglu_ff(p["ff"], layer_norm(x, p["norm3"])) + x


def spatial_transformer(p: Dict[str, Any], x, context, objs, heads: int,
                        gate_scale=1.0) -> torch.Tensor:
    """GN -> 1x1 proj_in -> transformer blocks over (h w) tokens -> 1x1
    proj_out + residual. x [B, H, W, C]."""
    b, h, w, _ = x.shape
    x_in = x
    x = group_norm(x, p["norm_scale"], p["norm_bias"])
    x = conv2d(x, p["proj_in_w"], p["proj_in_b"])
    x = x.reshape(b, h * w, -1)
    for blk in p["blocks"]:
        x = basic_transformer_block(blk, x, context, objs, heads, gate_scale)
    x = conv2d(x.reshape(b, h, w, -1), p["proj_out_w"], p["proj_out_b"])
    return x + x_in


def position_net(p: Dict[str, Any], boxes, masks, text_embeddings,
                 fourier_freqs: int = 8) -> torch.Tensor:
    """GLIGEN PositionNet: Fourier-embedded xyxy + phrase CLIP embeddings ->
    grounding tokens; padded slots take the learned null embeddings.
    boxes [B, N, 4], masks [B, N], text [B, N, context_dim]."""
    m = masks[..., None]
    xyxy = fourier_embed(boxes, fourier_freqs)
    text = text_embeddings * m + (1 - m) * p["null_positive"]
    xyxy = xyxy * m + (1 - m) * p["null_position"]
    h = torch.cat([text, xyxy], dim=-1)
    h = F.silu(h @ p["w0"] + p["b0"])
    h = F.silu(h @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]
