"""Decode chunks as captured CUDA graphs.

A CUDA graph is the port's form of the JAX package's single compiled decode
program (`jax.jit` over `lax.scan`): the decode chunks of `Generator`,
`generate_scan` and `PagedServer.step_n` are each one `Chunk`.

A `Chunk` runs `body()`, a function that reads and writes static buffers in
place and allocates nothing that outlives it. On the CPU every call runs the
body eagerly (what the CPU tests drive). On a CUDA device the first call,
made once the caller has filled the static inputs, first runs `warmup()`
(the body's first decode step, which writes what the replay's first step
writes again) on the chunk's capture stream, so that what the body needs is
made outside the capture: the int4 kernel's split-K tickets of that stream
(`kernels/int4_matmul._ticket`, kept per (device, stream) and left at 0 by
every launch), library handles, the allocator's first blocks. It then
captures `body()` into a `torch.cuda.CUDAGraph`, and every call, the first
included, replays the graph. A failed capture or replay raises; nothing
falls back to eager.

The kernel wrappers count their launches in Python
(`kernels.LAUNCH_COUNTERS`), so a launch that is captured ticks its count
although nothing runs, and a replay ticks nothing. A `Chunk` records at
capture how many launches of each kernel its graph holds (`launches`) and
takes those ticks back; each replay adds them to `replayed`. A run's
launches are the wrappers' counts (the warm-up's included) plus `replayed`.
"""
from __future__ import annotations

import collections
import importlib
from typing import Callable, Dict, Tuple

import torch

from vitron_tpu_torch.kernels import LAUNCH_COUNTERS

# (module, attribute) -> kernel launches made by graph replays since the last clear()
replayed: "collections.Counter[Tuple[str, str]]" = collections.Counter()


def _counters():
    return [(importlib.import_module(f"vitron_tpu_torch.kernels.{m}"), m, a)
            for _, m, a in LAUNCH_COUNTERS]


def kernel_counts() -> Dict[Tuple[str, str], int]:
    """Every wrapper's launch count as it stands."""
    return {(m, a): getattr(mod, a) for mod, m, a in _counters()}


class Chunk:
    """`body` run eagerly on the CPU, captured once and replayed on a CUDA
    device. `stream` is the capture stream and `pool` the graph memory pool
    (`torch.cuda.graph_pool_handle()`), both owned by the caller, which
    shares them between chunks that never run at the same time."""

    def __init__(self, body: Callable[[], None], warmup: Callable[[], None], device,
                 stream=None, pool=None):
        self.body, self.warmup = body, warmup
        self.cuda = torch.device(device).type == "cuda"
        self.stream, self.pool = stream, pool
        self.graph = None
        self.launches: Dict[Tuple[str, str], int] = {}

    def _capture(self) -> None:
        stream = self.stream
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            self.warmup()
        torch.cuda.current_stream().wait_stream(stream)
        before = kernel_counts()
        graph = torch.cuda.CUDAGraph()
        # thread_local: the HTTP and prep threads may touch the allocator
        # while the device loop captures
        with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.body()
        after = kernel_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        for mod, m, a in _counters():  # captured, not run
            setattr(mod, a, getattr(mod, a) - self.launches.get((m, a), 0))
        self.graph = graph

    @property
    def launches_per_call(self) -> int:
        return sum(self.launches.values())

    def __call__(self) -> None:
        if not self.cuda:
            self.body()
            return
        if self.graph is None:
            self._capture()
        self.graph.replay()
        replayed.update(self.launches)
