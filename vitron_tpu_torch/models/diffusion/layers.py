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

`position_net_with_image` (:429) is the style pipeline's text + image
grounding net. The checkpoint converters (:334-469) close the module, with
the pieces every diffusion converter reads a state dict through: `_np` (one
entry on the converter's device, widened), the `LAYOUTS` from the
reference's tensors to the port's, and `KeyMap`, on which a converter
returns its key map instead of a tree.
"""
from __future__ import annotations

import collections.abc
import math
import os
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

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
    # each group's value over its channels, [B, C]: an expand, whose gradient
    # is a sum (repeat_interleave's scatter-adds would not give the same
    # bits twice on the card)
    invc = inv[:, :, None].expand(b, groups, c // groups).reshape(b, c)
    muc = mu[:, :, None].expand(b, groups, c // groups).reshape(b, c)
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
    return _mlp3(p, torch.cat([text, xyxy], dim=-1))


def _mlp3(p: Dict[str, Any], h) -> torch.Tensor:
    """Linear, SiLU, Linear, SiLU, Linear."""
    h = F.silu(h @ p["w0"] + p["b0"])
    h = F.silu(h @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def position_net_with_image(p: Dict[str, Any], boxes, masks, text_masks, image_masks,
                            text_embeddings, image_embeddings,
                            fourier_freqs: int = 8) -> torch.Tensor:
    """GLIGEN text + image PositionNet: a text and an image MLP branch, each
    over [features, Fourier xyxy], concatenated to 2N grounding tokens.
    Masked-out features take the learned null text / image / position
    embeddings. boxes [B, N, 4]; masks, text_masks, image_masks [B, N];
    text and image embeddings [B, N, context_dim]."""
    m, tm, im = masks[..., None], text_masks[..., None], image_masks[..., None]
    xyxy = fourier_embed(boxes, fourier_freqs)
    text = text_embeddings * tm + (1 - tm) * p["null_text"]
    image = image_embeddings * im + (1 - im) * p["null_image"]
    xyxy = xyxy * m + (1 - m) * p["null_position"]
    objs_text = _mlp3(p["text"], torch.cat([text, xyxy], dim=-1))
    objs_image = _mlp3(p["image"], torch.cat([image, xyxy], dim=-1))
    return torch.cat([objs_text, objs_image], dim=1)


# ---------------------------------------------------------------- converters
#
# Port of the JAX converters (:334-469). A converter reads a reference state
# dict by name, as JAX's does, and returns the port's tree: dict for dict and
# key for key what `models.convert.from_jax` makes of the JAX converter's
# output on the same dict. Each entry is moved to the converter's `device`
# and widened there as it is looked up (`_np`), so on the card the host never
# holds a converted copy. Run on a `KeyMap` in place of a state dict, the same
# converter returns its key map: the tree with a `Key` at each leaf, which
# `synthetic.reference_state_dict` reads the other way to write a port tree
# out in the reference's layout. (`stablevideo.convert_imlp_torch` finds its
# layers from the keys a dict holds, so on a `KeyMap` it raises; its inverse
# is `synthetic.imlp_state_dict`.)


class Key(NamedTuple):
    """A leaf of a key map: the state-dict key it is read from (a tuple of
    keys: their tensors stacked on a new first axis) and the kind of layout
    that turns the reference's tensor into the port's (`LAYOUTS`)."""

    key: Union[str, Tuple[str, ...]]
    kind: str = "plain"


def _unpatch(w):
    """[p*p*3, C] -> the p x p patch conv's [C, 3, p, p]."""
    p = math.isqrt(w.shape[0] // 3)
    return w.reshape(p, p, 3, w.shape[1]).permute(3, 2, 0, 1)


# kind -> (the reference's layout -> the port's, the port's -> the reference's)
LAYOUTS = {
    "plain": (lambda t: t, lambda t: t),
    # nn.Linear [out, in] <-> x @ w's [in, out]
    "linear": (lambda t: t.t(), lambda t: t.t()),
    # torch conv OIHW <-> HWIO
    "conv": (lambda t: t.permute(2, 3, 1, 0), lambda t: t.permute(3, 2, 0, 1)),
    # a k=1 Conv1d [O, I, 1] <-> [I, O]
    "conv1d": (lambda t: t[:, :, 0].t(), lambda t: t.t()[:, :, None]),
    # a 1x1 Conv2d [O, I, 1, 1] <-> [I, O]
    "conv1x1": (lambda t: t[:, :, 0, 0].t(), lambda t: t.t()[:, :, None, None]),
    # a (3, 1, 1) Conv3d [O, I, 3, 1, 1] <-> [3, 1, I, O]
    "conv3d_t": (lambda t: t[:, :, :, 0, 0].permute(2, 1, 0)[:, None],
                 lambda t: t[:, 0].permute(2, 1, 0)[:, :, :, None, None]),
    # a p x p stride-p patch conv [C, 3, p, p] <-> a dense on flattened patches
    "patch": (lambda t: t.permute(2, 3, 1, 0).reshape(-1, t.shape[0]), _unpatch),
    # [1, N, C] <-> [N, C]
    "first": (lambda t: t[0], lambda t: t[None]),
}


class KeyMap:
    """Stands in for a state dict to record a converter's key map: every key
    is present and each entry looked up is its `Key`."""

    def __getitem__(self, key: str) -> Key:
        return Key(key)

    def __contains__(self, key) -> bool:
        return True

    def __iter__(self):
        return iter(())

    def items(self):
        return iter(())


def _np(x, device="cpu") -> torch.Tensor:
    """One state-dict entry (a tensor or a numpy array) as a new tensor on
    `device`: fp16 and bf16 widened to float32 there, exactly, as the JAX
    package's `_np` widens them; any other dtype as it is."""
    t = torch.as_tensor(x).detach()
    moved = t.to(device)
    if moved.dtype in (torch.float16, torch.bfloat16):
        return moved.float()
    return moved.clone() if moved is t else moved


class OnDevice(collections.abc.Mapping):
    """A state dict as the converters read it: each entry moved to `device`
    and widened (`_np`) when it is looked up, one at a time."""

    def __init__(self, sd: Mapping[str, Any], device):
        self.sd, self.device = sd, device

    def __getitem__(self, key: str) -> torch.Tensor:
        return _np(self.sd[key], self.device)

    def __contains__(self, key) -> bool:
        return key in self.sd

    def __iter__(self):
        return iter(self.sd)

    def __len__(self) -> int:
        return len(self.sd)


def reading(sd, device="cpu"):
    """`sd` as a converter reads it: a `KeyMap` or an `OnDevice` view as it
    is, any other mapping viewed on `device`."""
    return sd if isinstance(sd, (KeyMap, OnDevice)) else OnDevice(sd, device)


def sub_dict(sd, prefix: str):
    """The entries of a `reading` view under `prefix`, with it taken off
    their keys (a `KeyMap` as it is: its keys are recorded without it)."""
    if isinstance(sd, KeyMap):
        return sd
    return OnDevice({k[len(prefix):]: v for k, v in sd.sd.items() if k.startswith(prefix)},
                    sd.device)


def unprefixed(sd, prefix: str):
    """A `reading` view with `prefix` taken off each key that starts with
    it, the other keys as they are (a `KeyMap` as it is)."""
    if isinstance(sd, KeyMap):
        return sd
    return OnDevice({k[len(prefix):] if k.startswith(prefix) else k: v
                     for k, v in sd.sd.items()}, sd.device)


def layout(x, kind: str):
    """A read entry in the port's layout (a `Key`: its kind recorded)."""
    if isinstance(x, Key):
        return Key(x.key, kind)
    return LAYOUTS[kind][0](x).contiguous()


def stack(xs):
    """Entries of one stacked leaf, [L, ...] (`Key`s: one key of each)."""
    if isinstance(xs[0], Key):
        return Key(tuple(x.key for x in xs), xs[0].kind)
    return torch.stack(xs)


def conv_w(sd, key: str):
    """torch conv [O, I, kh, kw] -> HWIO."""
    return layout(sd[key], "conv")


def lin_w(sd, key: str):
    return layout(sd[key], "linear")


def convert_attention(sd, pfx: str, device="cpu") -> Dict[str, Any]:
    sd = reading(sd, device)
    return {
        "to_q": lin_w(sd, pfx + "to_q.weight"),
        "to_k": lin_w(sd, pfx + "to_k.weight"),
        "to_v": lin_w(sd, pfx + "to_v.weight"),
        "out_w": lin_w(sd, pfx + "to_out.0.weight"),
        "out_b": sd[pfx + "to_out.0.bias"],
    }


def convert_ln(sd, pfx: str, device="cpu") -> Dict[str, Any]:
    sd = reading(sd, device)
    return {"scale": sd[pfx + "weight"], "bias": sd[pfx + "bias"]}


def convert_ff(sd, pfx: str, device="cpu") -> Dict[str, Any]:
    sd = reading(sd, device)
    return {
        "proj_w": lin_w(sd, pfx + "net.0.proj.weight"),
        "proj_b": sd[pfx + "net.0.proj.bias"],
        "out_w": lin_w(sd, pfx + "net.2.weight"),
        "out_b": sd[pfx + "net.2.bias"],
    }


def convert_gated_sa(sd, pfx: str, device="cpu") -> Dict[str, Any]:
    sd = reading(sd, device)
    return {
        "linear_w": lin_w(sd, pfx + "linear.weight"),
        "linear_b": sd[pfx + "linear.bias"],
        "attn": convert_attention(sd, pfx + "attn."),
        "ff": convert_ff(sd, pfx + "ff."),
        "norm1": convert_ln(sd, pfx + "norm1."),
        "norm2": convert_ln(sd, pfx + "norm2."),
        "alpha_attn": sd[pfx + "alpha_attn"],
        "alpha_dense": sd[pfx + "alpha_dense"],
    }


def convert_transformer_block(sd, pfx: str, with_fuser: bool = True,
                              device="cpu") -> Dict[str, Any]:
    sd = reading(sd, device)
    p = {
        "attn1": convert_attention(sd, pfx + "attn1."),
        "attn2": convert_attention(sd, pfx + "attn2."),
        "ff": convert_ff(sd, pfx + "ff."),
        "norm1": convert_ln(sd, pfx + "norm1."),
        "norm2": convert_ln(sd, pfx + "norm2."),
        "norm3": convert_ln(sd, pfx + "norm3."),
    }
    if with_fuser and (pfx + "fuser.linear.weight") in sd:
        p["fuser"] = convert_gated_sa(sd, pfx + "fuser.")
    return p


def convert_spatial_transformer(sd, pfx: str, depth: int = 1, device="cpu") -> Dict[str, Any]:
    sd = reading(sd, device)
    return {
        "norm_scale": sd[pfx + "norm.weight"],
        "norm_bias": sd[pfx + "norm.bias"],
        "proj_in_w": conv_w(sd, pfx + "proj_in.weight"),
        "proj_in_b": sd[pfx + "proj_in.bias"],
        "proj_out_w": conv_w(sd, pfx + "proj_out.weight"),
        "proj_out_b": sd[pfx + "proj_out.bias"],
        "blocks": [convert_transformer_block(sd, f"{pfx}transformer_blocks.{i}.")
                   for i in range(depth)],
    }


def _convert_mlp3(sd, stem: str) -> Dict[str, Any]:
    """nn.Sequential(Linear, SiLU, Linear, SiLU, Linear) at `stem`."""
    return {"w0": lin_w(sd, stem + ".0.weight"), "b0": sd[stem + ".0.bias"],
            "w1": lin_w(sd, stem + ".2.weight"), "b1": sd[stem + ".2.bias"],
            "w2": lin_w(sd, stem + ".4.weight"), "b2": sd[stem + ".4.bias"]}


def convert_position_net(sd, pfx: str = "position_net.", device="cpu") -> Dict[str, Any]:
    sd = reading(sd, device)
    return {"null_positive": sd[pfx + "null_positive_feature"],
            "null_position": sd[pfx + "null_position_feature"],
            **_convert_mlp3(sd, pfx + "linears")}


def convert_position_net_with_image(sd, pfx: str = "position_net.",
                                    device="cpu") -> Dict[str, Any]:
    sd = reading(sd, device)
    return {
        "null_text": sd[pfx + "null_text_feature"],
        "null_image": sd[pfx + "null_image_feature"],
        "null_position": sd[pfx + "null_position_feature"],
        "text": _convert_mlp3(sd, pfx + "linears_text"),
        "image": _convert_mlp3(sd, pfx + "linears_image"),
    }
