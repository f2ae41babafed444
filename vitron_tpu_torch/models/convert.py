"""Carry parameters across from the JAX package.

`from_jax` takes the JAX param pytree with numpy leaves (on the JAX side:
`jax.tree.map(np.asarray, params)`) and returns the port's parameter dict,
dict for dict and key for key, so a port state-dict key is the JAX path
joined with ".". Quantized leaves ({"q4","s"}, {"q","s"}) carry over as
they are; the int4 packing is bit-identical.
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
