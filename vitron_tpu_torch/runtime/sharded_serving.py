"""Multi-GPU serving: mesh resolution, param and cache placement, and the
ranks' lockstep.

Port of `vitron_tpu/runtime/sharded_serving.py`. The flagship deployment
shards the Vicuna-7B LLM over the devices (fsdp x tensor,
`llama.LLAMA_SHARDING_RULES` under `vitron_model.VITRON_SHARDING_RULES`)
while the diffusion and SEEM backends stay replicated; the KV caches and the
paged pool hold each rank's KV heads (the head axis on `tensor`), so decode
attention is local to a rank and the Megatron split all-reduces once per
block.

The JAX package drives every chip from one process. Here one process runs
per device (`torchrun --nproc-per-node N`): rank 0 owns HTTP, the tokenizer
and the batcher's decisions, and every other rank follows in lockstep
(`ContinuousBatcher.follow`): before each device step rank 0 broadcasts one
fixed-size int64 control tensor (`Lockstep`) that says what the step is --
an admission with its token ids and sampling state, a decode chunk with its
rows' sampling state and uniforms, the sequences that finished -- followed,
for an admission, by its plan and media tensors. Nothing is pickled in the
loop, and the ranks sample the same tokens from the same logits and
uniforms.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from vitron_tpu_torch.core.mesh import (FSDP_AXIS, TENSOR_AXIS, Mesh, create_mesh,
                                        shard_params)


def serving_mesh(n_devices: Optional[int] = None) -> Mesh:
    """fsdp x tensor serving mesh over the world's n ranks (tensor=2 when n
    is even: KV heads split two ways keep attention local while fsdp bounds
    each rank's weight residency)."""
    n = n_devices or dist.get_world_size()
    tensor = 2 if n % 2 == 0 else 1
    return create_mesh({FSDP_AXIS: n // tensor, TENSOR_AXIS: tensor})


def resolve_serving_mesh(mesh: Any) -> Optional[Mesh]:
    """None | "auto" | Mesh -> a Mesh, or None for one device ("auto" in a
    process without a group, or a group of one rank)."""
    if mesh is None:
        return None
    if isinstance(mesh, Mesh):
        return mesh
    if mesh == "auto":
        n = dist.get_world_size() if dist.is_initialized() else 1
        return serving_mesh(n) if n > 1 else None
    raise ValueError(f"mesh must be None, 'auto', or a Mesh; got {mesh!r}")


def shard_llm_params(params, mesh: Mesh):
    """This rank's blocks of the full Vitron tree: LLM weights by the llama
    rules (fsdp x tensor), towers / projector / region by the ViT rules
    (replicated where dims do not divide)."""
    from vitron_tpu_torch.models import vitron_model

    return shard_params(params, mesh, vitron_model.VITRON_SHARDING_RULES)


def _kv_spec(mesh: Mesh, cfg_llm) -> tuple:
    tensor = mesh.shape.get(TENSOR_AXIS, 1)
    if tensor > 1 and cfg_llm.num_kv_heads % tensor == 0:
        return (None, None, None, TENSOR_AXIS, None)
    return ()


def kv_cache_shardings(mesh: Mesh, cfg_llm):
    """The spec of each `llama.KVCache` field: the KV-head axis (3 of
    [L, B, max_len, KV, D]) on `tensor`, replicated otherwise."""
    from vitron_tpu_torch.models.llm import llama

    spec = _kv_spec(mesh, cfg_llm)
    return llama.KVCache(k=spec, v=spec, index=(), valid=())


def paged_pool_shardings(mesh: Mesh, cfg_llm) -> tuple:
    """The spec of the paged pool's k/v [L, nb, bs, KV, D]: KV heads on
    `tensor`."""
    return _kv_spec(mesh, cfg_llm)


def install_mesh(system, mesh: Mesh) -> None:
    """Wire a built system for mesh execution: shard its resident LLM
    params (the generator's caches then hold this rank's KV heads), record
    the LLM as sharded in its memory plan, and remember the mesh so serving
    components (ContinuousBatcher) run on it."""
    from vitron_tpu_torch.core.mesh import tree_paths
    from vitron_tpu_torch.runtime.memory_plan import tree_bytes

    gen = system.engine.generator
    gen.set_params(shard_llm_params(gen.params, mesh))
    plan = getattr(system, "memory_plan", None)
    if plan is not None:  # this rank's blocks against the full tree's bytes
        total = tree_bytes(gen.params)
        local = sum(tree_bytes(getattr(leaf, "local", leaf)) for _, leaf in tree_paths(gen.params))
        plan.chips = mesh.size
        plan.add("llm+towers", total, shard_factor=max(1, round(total / max(local, 1))))
    system.serving_mesh = mesh


def follow(system, **pipeline_kw) -> None:
    """A follower rank's serving loop: the batched pipeline rank 0 serves
    with (the same arguments), run in lockstep until rank 0 closes it."""
    from vitron_tpu_torch.runtime.pipeline import ServingPipeline

    pipeline = ServingPipeline(system, **pipeline_kw)
    try:
        pipeline.batcher.follow()
    finally:
        pipeline.close()


# ------------------------------------------------------------------ lockstep


def f64_bits(x) -> np.ndarray:
    """Floats as int64 (their float64 bit patterns), for a control tensor:
    exact for Python floats and float32 values alike."""
    return np.asarray(x, np.float64).reshape(-1).view(np.int64)


def from_f64_bits(b) -> np.ndarray:
    return np.asarray(b, np.int64).view(np.float64)


class Lockstep:
    """Rank 0 -> every rank of the default group: a control tensor of
    `size` int64 an op (`send` / `recv`), then the op's tensors, whose
    shapes and dtypes the control tensor gave (`send_tensor` /
    `recv_tensor`). The tensors live on `device` (the card under NCCL)."""

    def __init__(self, size: int, device):
        self.size = size
        self.device = torch.device(device)
        self.primary = dist.get_rank() == 0
        self._ctrl = torch.zeros(size, dtype=torch.int64, device=self.device)

    def send(self, values: Sequence[int]) -> None:
        if len(values) > self.size:
            raise ValueError(f"control message of {len(values)} > {self.size} slots")
        self._ctrl.zero_()
        self._ctrl[:len(values)] = torch.as_tensor(np.asarray(values, np.int64),
                                                   device=self.device)
        dist.broadcast(self._ctrl, src=0)

    def recv(self) -> np.ndarray:
        dist.broadcast(self._ctrl, src=0)
        return self._ctrl.cpu().numpy()

    def send_tensor(self, t: torch.Tensor) -> None:
        dist.broadcast(t.contiguous(), src=0)

    def recv_tensor(self, shape, dtype) -> torch.Tensor:
        t = torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=self.device)
        dist.broadcast(t, src=0)
        return t
