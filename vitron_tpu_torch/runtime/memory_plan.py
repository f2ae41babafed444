"""Resident multi-model device-memory budget planning.

Port of `vitron_tpu/runtime/memory_plan.py`. The reference dodges memory
planning by re-loading every backend's checkpoint from disk per request
(reference: app.py:94-103, 228, 295-303, 324). Here all backends stay
resident, so placement against the device's memory is an explicit,
checkable plan: `MemoryPlan` sums actual tensor bytes (quantized dicts
included) and fails fast at registration time instead of running out of
memory mid-request.

A plan is for one device. On a CUDA device its budget defaults to the card's
total memory (`torch.cuda.get_device_properties(d).total_memory`); off the
card the caller names the budget, there is no default size. Placement over
several devices (sharded and replicated entries) waits on the mesh path
(ROADMAP A16).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


def tree_bytes(tree: Any) -> int:
    """Total bytes of every tensor (or numpy array) leaf of nested dicts,
    lists and tuples."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if hasattr(tree, "nbytes") and hasattr(tree, "dtype"):
        return int(tree.nbytes)
    return 0


def device_budget_bytes(device) -> int:
    """A CUDA device's total memory: the budget of a plan on it."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"no memory budget is known for device {device}: "
                         f"pass budget_bytes (MemoryPlan(budget_bytes=...))")
    return int(torch.cuda.get_device_properties(device).total_memory)


@dataclasses.dataclass
class MemoryPlan:
    """Tracks resident model placement against one device's budget."""

    budget_bytes: int
    reserve_bytes: int = 2 * 1024 ** 3          # activations / cache headroom
    entries: Dict[str, int] = dataclasses.field(default_factory=dict)

    @staticmethod
    def for_device(device, **kw) -> "MemoryPlan":
        """A plan whose budget is a CUDA device's memory (`device_budget_bytes`)."""
        return MemoryPlan(budget_bytes=device_budget_bytes(device), **kw)

    def add(self, name: str, params_or_bytes: Any, strict: bool = False) -> int:
        """Register a resident model; returns its measured bytes.
        strict=True raises when the plan no longer fits instead of just
        recording it."""
        n = (int(params_or_bytes) if isinstance(params_or_bytes, int)
             else tree_bytes(params_or_bytes))
        self.entries[name] = n
        if strict and not self.fits:
            raise MemoryError(
                f"memory plan over budget adding {name!r}:\n{self.report()}")
        return n

    @property
    def resident_bytes(self) -> int:
        return sum(self.entries.values())

    @property
    def fits(self) -> bool:
        return self.resident_bytes + self.reserve_bytes <= self.budget_bytes

    def report(self) -> str:
        gib = 1024 ** 3
        lines = [f"{name:<24} {n / gib:7.2f} GiB"
                 for name, n in sorted(self.entries.items(), key=lambda kv: -kv[1])]
        lines.append(f"{'resident total':<24} {self.resident_bytes / gib:7.2f} GiB")
        lines.append(f"{'reserve (act/cache)':<24} {self.reserve_bytes / gib:7.2f} GiB")
        lines.append(f"{'budget':<24} {self.budget_bytes / gib:7.2f} GiB"
                     f"  ({'OK' if self.fits else 'OVER'})")
        return "\n".join(lines)
