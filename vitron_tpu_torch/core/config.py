"""One configuration tree for a deployment, with a JSON round trip.

Port of `vitron_tpu/core/config.py`. The reference juggles five config
systems at once (HF dataclass args, argparse, OmegaConf pickled in a .pth,
yaml with a registry, DeepSpeed JSON); every component here takes a frozen
dataclass, and `SystemConfig` is the top of one tree, saved and loaded as
one JSON file. A torch dtype is written as its name ("bfloat16") and read
back as the dtype; unknown keys are refused.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, Optional, Type, TypeVar

import torch

T = TypeVar("T")
DTYPE_NAMES = ("bfloat16", "float32", "float16")


def to_dict(cfg: Any) -> Any:
    """A frozen-dataclass tree -> plain dicts, lists and scalars (a torch
    dtype -> its name, a class -> its name)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, torch.dtype):
        return str(cfg).removeprefix("torch.")
    if isinstance(cfg, type):
        return cfg.__name__
    return cfg


def from_dict(cls: Type[T], data: Dict[str, Any]) -> T:
    """Plain dicts -> a dataclass tree: a nested dataclass field (known by
    its default) recurses, a dtype name becomes the torch dtype, a list a
    tuple; unknown keys raise ValueError."""
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        f = fields[name]
        if isinstance(value, dict):
            default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                       else f.default)
            if dataclasses.is_dataclass(default):
                kwargs[name] = from_dict(type(default), value)
                continue
        if isinstance(value, str) and value in DTYPE_NAMES:
            value = getattr(torch, value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[name] = value
    return cls(**kwargs)


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """The top of a deployment's tree: which backends to enable and where
    their checkpoints live."""

    base_model: str = ""
    lora_path: str = ""
    seem_checkpoint: str = ""
    gligen_gen_checkpoint: str = ""
    gligen_inpaint_checkpoint: str = ""
    sd_vae_checkpoint: str = ""
    clip_text_checkpoint: str = ""
    controlnet_checkpoint: str = ""
    t2v_checkpoint: str = ""
    i2v_checkpoint: str = ""
    conv_template: str = "llava_v1"
    mesh_shape: Optional[Dict[str, int]] = None
    quantize_llm: str = ""           # "" | "int8" | "int4"
    enable: tuple = ("A", "B", "C", "D", "E", "F", "G")

    @staticmethod
    def load(path) -> "SystemConfig":
        return from_dict(SystemConfig, json.loads(pathlib.Path(path).read_text()))

    def save(self, path) -> None:
        pathlib.Path(path).write_text(json.dumps(to_dict(self), indent=2))
