"""HF checkpoint loading for the Llama decoder, in PyTorch.

Port of `vitron_tpu/models/llm/loader.py`: base Llama/Vicuna weights from
safetensors or torch `.bin` shards, an optional peft LoRA adapter merged at
load time (W += B A * alpha / r, each target as it is read: `lora_pairs`
and `merged` are the JAX `merge_lora` split so), and host-style int8/int4
weight-only quantization of the projections and `lm_head` into the
`{"q","s"}` / `{"q4","s"}` leaves of `kernels/quantization.py`, bit-equal
to the JAX package's `quantize_host`.

The safetensors reader is the port's own (`load_safetensors_dir`): the
format is an 8-byte little-endian header length, a JSON header of dtype,
shape and byte offsets, then the raw bytes. It reads F32, F16, BF16, I8,
U8, I32 and I64, lazily: a tensor's bytes are read when it is looked up.
BF16 is widened to float32, as the JAX package's `_np` widens a bf16 `.bin`
tensor, so a bf16 shard and a bf16 `.bin` load alike; the JAX reader keeps
a bf16 shard's tensors in bf16 (ROADMAP C16).

`load_pretrained_llama` converts tensor by tensor onto the target device:
each weight is read, LoRA-merged, cast through float32 to the param dtype,
transposed and, with `quantize`, quantized one layer at a time into
preallocated stacked leaves (a LoRA product is the host's float32 matmul,
as JAX's numpy merge computes it). Neither the host nor the device ever holds the
whole unquantized model; the order of the roundings is JAX's (convert to
the param dtype, then quantize), so the bits are JAX's.
"""
from __future__ import annotations

import collections.abc
import json
import pathlib
import re
import struct
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from vitron_tpu_torch.kernels.quantization import (LLAMA_PROJECTIONS, quantize_int4,
                                                   quantize_int8, quantize_llama)
from vitron_tpu_torch.models.llm.llama import LlamaConfig

SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
                      "I8": torch.int8, "U8": torch.uint8, "I32": torch.int32,
                      "I64": torch.int64}

# port key -> (HF name of layer i, transposed [out, in] -> [in, out])
LAYER_WEIGHTS = {
    "attn_norm": ("model.layers.{}.input_layernorm.weight", False),
    "wq": ("model.layers.{}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{}.self_attn.o_proj.weight", True),
    "mlp_norm": ("model.layers.{}.post_attention_layernorm.weight", False),
    "gate": ("model.layers.{}.mlp.gate_proj.weight", True),
    "up": ("model.layers.{}.mlp.up_proj.weight", True),
    "down": ("model.layers.{}.mlp.down_proj.weight", True),
}


def widen(t: torch.Tensor) -> torch.Tensor:
    """bf16 -> float32, any other dtype as it is (the JAX package's `_np`)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def read_safetensors_header(path) -> Tuple[Dict[str, Dict[str, Any]], int]:
    """-> ({name: {"dtype", "shape", "data_offsets"}}, the byte where the
    data starts); the header's `__metadata__` entry is dropped."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def read_tensor(path, entry: Mapping[str, Any], data_start: int) -> torch.Tensor:
    """One header entry's tensor, read from disk into host memory (bf16
    widened to float32)."""
    if entry["dtype"] not in SAFETENSORS_DTYPES:
        raise TypeError(f"{path}: safetensors dtype {entry['dtype']} is not read "
                        f"(only {sorted(SAFETENSORS_DTYPES)})")
    dtype = SAFETENSORS_DTYPES[entry["dtype"]]
    begin, end = entry["data_offsets"]
    buf = bytearray(end - begin)
    with open(path, "rb") as fh:
        fh.seek(data_start + begin)
        if fh.readinto(buf) != len(buf):
            raise ValueError(f"{path}: truncated tensor data")
    t = torch.frombuffer(buf, dtype=dtype) if buf else torch.empty(0, dtype=dtype)
    return widen(t.reshape(entry["shape"]))


class LazyTensors(collections.abc.MutableMapping):
    """A state dict over safetensors files: a tensor's bytes are read when it
    is looked up. Assigned entries (a merged weight, tied embeddings, `.bin`
    tensors added with `update`) are held as given."""

    def __init__(self, files=()):
        self._where: Dict[str, Tuple[Any, Dict[str, Any], int]] = {}
        self._held: Dict[str, Any] = {}
        for f in files:
            header, start = read_safetensors_header(f)
            for name, entry in header.items():
                self._where[name] = (f, entry, start)

    def __getitem__(self, name: str):
        if name in self._held:
            return self._held[name]
        return read_tensor(*self._where[name])

    def __setitem__(self, name: str, value) -> None:
        self._held[name] = value

    def __delitem__(self, name: str) -> None:
        if name not in self._held and name not in self._where:
            raise KeyError(name)
        self._held.pop(name, None)
        self._where.pop(name, None)

    def __iter__(self) -> Iterator[str]:
        yield from self._where
        yield from (k for k in self._held if k not in self._where)

    def __len__(self) -> int:
        return len(self._where.keys() | self._held.keys())


def load_safetensors_dir(path) -> LazyTensors:
    """Every *.safetensors shard of a checkpoint dir (the files that
    `model.safetensors.index.json` names, when present) as one lazy state
    dict."""
    path = pathlib.Path(path)
    index = path / "model.safetensors.index.json"
    files = (sorted({path / v for v in json.loads(index.read_text())["weight_map"].values()})
             if index.exists() else sorted(path.glob("*.safetensors")))
    return LazyTensors(files)


def load_torch_bin(path) -> Dict[str, torch.Tensor]:
    """A torch-serialized .bin (non_lora_trainables, legacy shards), bf16
    widened to float32."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: widen(v) for k, v in sd.items()}


def as_tensor(x) -> torch.Tensor:
    """A numpy array (a `.npz` entry) as a tensor; a tensor as it is."""
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


def lora_pairs(state_dict: Mapping[str, Any], lora_state: Mapping[str, Any],
               scaling: Optional[float] = None, r: Optional[int] = None,
               alpha: Optional[int] = None) -> Dict[str, Tuple[Any, Any, float]]:
    """peft LoRA keys -> {target weight name in state_dict: (A [r, in], B
    [out, r], scaling)}. peft keys look like
    base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight; a
    target missing from state_dict is tried without its leading 'model.'."""
    if scaling is None:
        scaling = (alpha / r) if (alpha and r) else 1.0
    found: Dict[str, Dict[str, str]] = {}
    for k in lora_state:
        m = re.match(r"(?:base_model\.model\.)?(.*)\.lora_(A|B)\.(?:default\.)?weight", k)
        if m:
            found.setdefault(m.group(1), {})[m.group(2)] = k
    out = {}
    for base, ab in found.items():
        if "A" not in ab or "B" not in ab:
            continue
        target = base + ".weight"
        if target not in state_dict:
            target = target.split(".", 1)[-1]
            if target not in state_dict:
                continue
        out[target] = (ab["A"], ab["B"], scaling)
    return out


def merged(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor, scaling: float) -> torch.Tensor:
    """W + (B @ A) * scaling, rounded to W's dtype, on W's device. B @ A is
    the host's float32 product, as the JAX package's numpy merge takes it
    (a card's sums would round otherwise), scaled in float32; the add and
    the rounding are exact IEEE operations on any device."""
    delta = (b.to("cpu", torch.float32) @ a.to("cpu", torch.float32)) * scaling
    return (w.float() + delta.to(w.device)).to(w.dtype)


def _quantize(w: torch.Tensor, bits: int) -> Dict[str, torch.Tensor]:
    return quantize_int8(w) if bits == 8 else quantize_int4(w)


def convert_hf_llama(state_dict: Mapping[str, Any], cfg: LlamaConfig, device="cpu",
                     bits: int = 0, lora: Optional[Mapping[str, Tuple[Any, Any, float]]] = None,
                     lora_state: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """HF LlamaForCausalLM state dict -> the port's stacked-layer param dict
    on `device`, each leaf at `cfg.param_dtype` (through float32, as JAX
    casts). HF linear weights are [out, in]; ours [in, out] (x @ w).

    Tensor by tensor: with `lora` (from `lora_pairs`, the factors looked up
    in `lora_state`) each target is merged as it is read; with bits 8 or 4
    each layer's projections, and lm_head, are quantized as they are
    converted (`quantize_host`'s leaves, head included)."""
    device = torch.device(device)
    dt = cfg.param_dtype
    lora = lora or {}

    def get(name: str, transpose: bool) -> torch.Tensor:
        w = as_tensor(state_dict[name]).to(device)
        if name in lora:
            ka, kb, s = lora[name]
            w = merged(w, as_tensor(lora_state[ka]), as_tensor(lora_state[kb]), s)
        w = w.to(torch.float32).to(dt)
        return w.t().contiguous() if transpose else w

    def stack(key: str):
        fmt, transpose = LAYER_WEIGHTS[key]
        quant = bits and key in LLAMA_PROJECTIONS
        out = None
        for i in range(cfg.num_layers):
            w = get(fmt.format(i), transpose)
            leaf = _quantize(w, bits) if quant else {"w": w}
            if out is None:
                out = {k: torch.empty((cfg.num_layers,) + tuple(v.shape), dtype=v.dtype,
                                      device=device) for k, v in leaf.items()}
            for k, v in leaf.items():
                out[k][i] = v
        return out if quant else out["w"]

    head = get("lm_head.weight", True)
    return {
        "embed": get("model.embed_tokens.weight", False),
        "layers": {key: stack(key) for key in LAYER_WEIGHTS},
        "final_norm": get("model.norm.weight", False),
        "lm_head": _quantize(head, bits) if bits else head,
    }


def quantize_host(params: Dict[str, Any], bits: int = 8) -> Dict[str, Any]:
    """Weight-only quantization of a converted param dict, the JAX
    `quantize_host`: int8 {"q","s"} or packed int4 {"q4","s"} per output
    channel, the seven projections and lm_head. The port quantizes on any
    device, so this is `quantize_llama` with the head on."""
    return quantize_llama(params, bits, head=True)


def load_lora_dir(lora_path) -> Tuple[LazyTensors, Optional[int], Optional[int]]:
    """A peft adapter dir -> (its lazy state dict, r, lora_alpha); r and
    alpha come from adapter_config.json when it is there."""
    lp = pathlib.Path(lora_path)
    r = alpha = None
    cfg_file = lp / "adapter_config.json"
    if cfg_file.exists():
        acfg = json.loads(cfg_file.read_text())
        r, alpha = acfg.get("r"), acfg.get("lora_alpha")
    lora_sd = LazyTensors(sorted(lp.glob("adapter_model.safetensors")))
    for f in sorted(lp.glob("adapter_model.bin")):
        lora_sd.update(load_torch_bin(f))
    return lora_sd, r, alpha


def load_pretrained_llama(base_path, cfg: LlamaConfig, lora_path: Optional[str] = None,
                          quantize: str = "", device="cpu") -> Dict[str, Any]:
    """Base shards (+ an optional LoRA adapter, merged) (+ optional int8 or
    int4 weight-only quantization) -> the param dict on `device`."""
    sd = load_safetensors_dir(base_path)
    if not sd:  # legacy torch shards
        for f in sorted(pathlib.Path(base_path).glob("pytorch_model*.bin")):
            sd.update(load_torch_bin(f))
    if "lm_head.weight" not in sd and "model.embed_tokens.weight" in sd:
        sd["lm_head.weight"] = sd["model.embed_tokens.weight"]  # tied embeddings
    lora, lora_sd = None, None
    if lora_path:
        lora_sd, r, alpha = load_lora_dir(lora_path)
        lora = lora_pairs(sd, lora_sd, r=r, alpha=alpha)
    bits = {"int8": 8, "int4": 4}.get(quantize, 0)
    return convert_hf_llama(sd, cfg, device, bits=bits, lora=lora, lora_state=lora_sd)
