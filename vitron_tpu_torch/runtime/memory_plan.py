"""Resident multi-model device-memory budget planning.

Port of `vitron_tpu/runtime/memory_plan.py`. The reference dodges memory
planning by re-loading every backend's checkpoint from disk per request
(reference: app.py:94-103, 228, 295-303, 324). Here all backends stay
resident, so placement against the device's memory is an explicit,
checkable plan: `MemoryPlan` sums actual tensor bytes (quantized dicts
included) and fails fast at registration time instead of running out of
memory mid-request.

A plan's budget is per device. On a CUDA device it defaults to the card's
total memory (`torch.cuda.get_device_properties(d).total_memory`); off the
card the caller names the budget, there is no default size. A deployment
over several devices (Vicuna-7B sharded over the mesh, backends
replicated) sets `chips` > 1 and marks sharded entries: a sharded entry
costs total/chips a device (or total/shard_factor when it is split over a
sub-axis only, as the paged KV pool over `tensor`), a replicated entry its
full size on every device; `fits` and `report` are per device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from vitron_tpu_torch.core.mesh import Shard


def tree_bytes(tree: Any) -> int:
    """Total bytes of every tensor (or numpy array) leaf of nested dicts,
    lists and tuples."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, Shard):  # the full tensor's bytes, as a sharded jax.Array's nbytes
        return tree.nbytes
    if hasattr(tree, "nbytes") and hasattr(tree, "dtype"):
        return int(tree.nbytes)
    return 0


def kv_cache_bytes(num_layers: int, batch: int, max_len: int, kv_heads: int,
                   head_dim: int, bytes_per_el: int = 2) -> int:
    """Preallocated dense KV cache footprint (k + v)."""
    return 2 * num_layers * batch * max_len * kv_heads * head_dim * bytes_per_el


def device_budget_bytes(device) -> int:
    """A CUDA device's total memory: the budget of a plan on it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no memory budget is known for device {device}: "
                         f"pass budget_bytes (MemoryPlan(budget_bytes=...))")
    return int(torch.cuda.get_device_properties(device).total_memory)


@dataclasses.dataclass
class MemoryPlan:
    """Tracks resident model placement against a per-device budget over
    `chips` devices (the module docstring)."""

    budget_bytes: int
    reserve_bytes: int = 2 * 1024 ** 3          # activations / cache headroom
    chips: int = 1
    entries: Dict[str, int] = dataclasses.field(default_factory=dict)
    sharded: Dict[str, bool] = dataclasses.field(default_factory=dict)
    shard_factor: Dict[str, int] = dataclasses.field(default_factory=dict)

    @staticmethod
    def for_device(device, **kw) -> "MemoryPlan":
        """A plan whose budget is a CUDA device's memory (`device_budget_bytes`)."""
        return MemoryPlan(budget_bytes=device_budget_bytes(device), **kw)

    def add(self, name: str, params_or_bytes: Any, strict: bool = False,
            sharded: bool = False, shard_factor: int = 0) -> int:
        """Register a resident model; returns its measured TOTAL bytes.

        sharded=True: split over all `chips` (total/chips a device); an
        entry split over a mesh sub-axis only passes that split as
        shard_factor (total/shard_factor a device). strict=True raises when
        the plan no longer fits instead of just recording it."""
        n = (int(params_or_bytes) if isinstance(params_or_bytes, int)
             else tree_bytes(params_or_bytes))
        self.entries[name] = n
        self.sharded[name] = bool(sharded) or shard_factor > 1
        self.shard_factor[name] = (int(shard_factor) if shard_factor > 1
                                   else (self.chips if sharded else 1))
        if strict and not self.fits:
            raise MemoryError(
                f"memory plan over budget adding {name!r}:\n{self.report()}")
        return n

    def per_chip_bytes(self, name: str) -> int:
        return -(-self.entries[name] // max(self.shard_factor.get(name, 1), 1))

    @property
    def resident_bytes(self) -> int:
        """Bytes resident on each device (the total when chips == 1)."""
        return sum(self.per_chip_bytes(k) for k in self.entries)

    @property
    def fits(self) -> bool:
        return self.resident_bytes + self.reserve_bytes <= self.budget_bytes

    def report(self) -> str:
        gib = 1024 ** 3
        lines = []
        if self.chips > 1:
            lines.append(f"placement over {self.chips} chips "
                         f"(per-chip budget {self.budget_bytes / gib:.0f} GiB):")
        for name, n in sorted(self.entries.items(), key=lambda kv: -kv[1]):
            if self.chips == 1:
                lines.append(f"{name:<24} {n / gib:7.2f} GiB")
                continue
            tag = (f"  sharded/{self.shard_factor[name]}" if self.sharded.get(name)
                   else "  replicated")
            lines.append(f"{name:<24} {self.per_chip_bytes(name) / gib:7.2f} GiB/chip"
                         f" (total {n / gib:6.2f}){tag}")
        per = "/chip" if self.chips > 1 else ""
        lines.append(f"{'resident total':<24} {self.resident_bytes / gib:7.2f} GiB{per}")
        lines.append(f"{'reserve (act/cache)':<24} {self.reserve_bytes / gib:7.2f} GiB")
        lines.append(f"{'budget':<24} {self.budget_bytes / gib:7.2f} GiB"
                     f"  ({'OK' if self.fits else 'OVER'})")
        return "\n".join(lines)
