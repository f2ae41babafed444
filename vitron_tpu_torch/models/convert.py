"""Carry parameters across from the JAX package.

`from_jax` takes the JAX param pytree with numpy leaves (on the JAX side:
`jax.tree.map(np.asarray, params)`) and returns the port's parameter dict,
dict for dict and key for key, so a port state-dict key is the JAX path
joined with ".". Quantized leaves ({"q4","s"}, {"q","s"}) carry over as
they are; the int4 packing is bit-identical. The diffusion trees carry
over the same way, the task-F ones included: the ControlNet's (the UNet
encoder copy, `hint_block`, `zero_convs`, `middle_out`), DPT's (`resnet`,
`blocks`, `readout`, `post*`, `scratch`, `fusion`, `head`), the IMLP's
(`layers`) and AGGNet's (`w1`, `w2`). `to_numpy` goes back: the
same structure of numpy arrays (bfloat16 as float32, which numpy holds),
for the JAX side to take with `jnp.asarray` -- e.g. a trainer's trainable
tree (LoRA factors, projector, region) at the same key paths.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: reinterpret the bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def from_jax(tree: Any, device) -> Any:
    """Nested dicts/lists of numpy arrays -> the same structure of tensors
    on `device`."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax(v, device) for v in tree)
    return _tensor(tree, device)


def to_numpy(tree: Any) -> Any:
    """Nested dicts/lists of tensors -> the same structure of numpy arrays
    (detached, on the host; bfloat16 widened to float32)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()
