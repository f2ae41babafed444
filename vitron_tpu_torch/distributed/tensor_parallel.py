"""Megatron tensor parallelism and fsdp gathers over `Shard` weights.

The JAX package leaves these collectives to GSPMD. Here they are written
out, for weights placed by the llama rules (`llama.LLAMA_SHARDING_RULES`):

- `fsdp` shards a weight at rest: `gather` all-gathers it just before the
  layer that uses it, and the gathered copy is freed after that layer;
- `tensor` splits a column-parallel weight (wq / wk / wv / gate / up: the
  output dim) and a row-parallel one (wo / down: the input dim). A pair of
  them runs on this rank's heads or hidden units only, and the row
  product's partial sums are all-reduced (`row_linear`): in float32 (or
  a wider input's type) when the group has more than one rank, so the
  shards' sums are added before the one cast to the compute dtype;
- a column-split weight used alone (lm_head, split by vocabulary) gives
  its block of the output, gathered along the last dim (`linear`).

A pair whose specs do not form the Megatron split (an axis dropped by
`fit_spec`, LoRA factors) is gathered whole and runs replicated.

For training each collective carries its gradient (`core/mesh.py`): a
gather's is this rank's slice, `row_linear`'s all-reduce ("g") passes it
as it is, and `copy_to_group` (Megatron's "f": the identity, its gradient
summed over the group) stands at the input of each column-split product,
whose gradient with respect to that input is this rank's part only.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from vitron_tpu_torch.core.mesh import TENSOR_AXIS, Shard, all_gather, all_reduce
from vitron_tpu_torch.kernels.quantization import matmul_maybe_quantized as _mm

_MAIN_KEYS = ("q4", "qa8", "q8", "q")


def _main(w) -> Any:
    """The leaf whose spec decides a weight's role: the tensor itself, or
    the integer matrix of a quantized dict."""
    if isinstance(w, dict):
        for k in _MAIN_KEYS:
            if k in w:
                return w[k]
        return None
    return w


def sharded(w) -> bool:
    if isinstance(w, dict):
        return any(isinstance(v, Shard) for v in w.values())
    return isinstance(w, Shard)


def mesh_of(w):
    m = _main(w)
    if isinstance(m, Shard):
        return m.mesh
    if isinstance(w, dict):
        for v in w.values():
            if isinstance(v, Shard):
                return v.mesh
    return None


def role(w) -> Optional[str]:
    """"col" (output dim on `tensor`), "row" (input dim on `tensor`) or None."""
    m = _main(w)
    if not isinstance(m, Shard) or len(m.spec) < 2:
        return None
    if m.spec[-1] == TENSOR_AXIS:
        return "col"
    if m.spec[-2] == TENSOR_AXIS:
        return "row"
    return None


def pair_group(lp, cols: Sequence[str], row: str):
    """The `tensor` process group when cols are column-parallel and row is
    row-parallel (the Megatron split of one block), else None."""
    ws = [lp[c] for c in cols] + [lp[row]]
    if any(isinstance(w, dict) and "lora_a" in w for w in ws):
        return None
    if all(role(lp[c]) == "col" for c in cols) and role(lp[row]) == "row":
        return mesh_of(lp[row]).group(TENSOR_AXIS)
    return None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def gather(w, keep: Sequence[str] = ()):
    """A weight (tensor, Shard or a dict of them) with every sharded dim
    all-gathered but those split over an axis in `keep`."""
    if isinstance(w, Shard):
        return w.gather(keep)
    if isinstance(w, dict):
        return {k: gather(v, keep) for k, v in w.items()}
    return w


class _CopyToGroup(torch.autograd.Function):
    """Megatron's "f": the identity; backward: the gradient summed over the
    group (in float32 or wider past one rank, as `row_linear`'s partials)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        acc = g.dtype if dist.get_world_size(ctx.group) == 1 else torch.promote_types(
            g.dtype, torch.float32)
        total = g.to(acc, memory_format=torch.contiguous_format, copy=True)
        return all_reduce(total, ctx.group).to(g.dtype), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """x at the input of a column-split product over `group`: as it is, and
    in the backward the ranks' parts of its gradient summed."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToGroup.apply(x, group)
    return x


def row_linear(x: torch.Tensor, w, group) -> torch.Tensor:
    """x (this rank's block of the input dim) @ w (its rows), the partial
    sums all-reduced over `group`; `group` None is a plain product."""
    if group is None:
        return _mm(x, w)
    if dist.get_world_size(group) == 1:
        return all_reduce(_mm(x, w), group)
    acc = torch.promote_types(x.dtype, torch.float32)
    y = _mm(x.to(acc), w if isinstance(w, dict) else w.to(acc))
    return all_reduce(y, group).to(x.dtype)


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a whole weight (lm_head), whatever its placement: a column
    split gives this rank's output block, gathered along the last dim; any
    other placement is gathered whole first."""
    if not sharded(w):
        return _mm(x, w)
    if role(w) != "col":
        return _mm(x, gather(w))
    group = mesh_of(w).group(TENSOR_AXIS)
    y = _mm(copy_to_group(x, group), gather(w, keep=(TENSOR_AXIS,)))
    return all_gather(y, group, dim=y.dim() - 1)
