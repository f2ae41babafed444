"""Weight delta / consolidation tools.

Port of `vitron_tpu/models/weight_tools.py`, a numpy host module the port
keeps its own copy of (the code as it is; `tests/test_torch_no_jax_imports.py`
holds it to the original). It rebuilds the reference utilities (reference:
vitron/model/apply_delta.py:13, make_delta.py, consolidate.py:11):
vicuna-style weight deltas (target = base + delta, with vocab-growth
handling) and checkpoint consolidation, on flat numpy state dicts, so it
works on HF checkpoints and on either package's param trees.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def apply_delta(base: Dict[str, np.ndarray],
                delta: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """target = base + delta (apply_delta.py:13-40). Delta entries absent
    from base pass through; embedding rows added by the delta's larger vocab
    are kept (vicuna adds special tokens)."""
    out: Dict[str, np.ndarray] = {}
    for k, dv in delta.items():
        if k not in base:
            out[k] = dv
            continue
        bv = base[k]
        if bv.shape == dv.shape:
            out[k] = bv + dv
        else:
            # vocab growth: delta rows beyond base are absolute values
            assert dv.shape[1:] == bv.shape[1:], f"shape mismatch at {k}"
            n = bv.shape[0]
            merged = dv.copy()
            merged[:n] = merged[:n] + bv
            out[k] = merged
    return out


def make_delta(base: Dict[str, np.ndarray],
               target: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """delta = target - base (make_delta.py), inverse of apply_delta."""
    out: Dict[str, np.ndarray] = {}
    for k, tv in target.items():
        if k not in base:
            out[k] = tv
            continue
        bv = base[k]
        if bv.shape == tv.shape:
            out[k] = tv - bv
        else:
            assert tv.shape[1:] == bv.shape[1:]
            n = bv.shape[0]
            d = tv.copy()
            d[:n] = d[:n] - bv
            out[k] = d
    return out


def consolidate(shards: list) -> Dict[str, np.ndarray]:
    """Merge sharded state dicts into one (consolidate.py:11-30). Later
    shards win on key collisions (HF shard layout has disjoint keys)."""
    out: Dict[str, np.ndarray] = {}
    for sd in shards:
        out.update(sd)
    return out
