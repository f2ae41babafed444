"""Process-group initialisation for multi-GPU runs.

Port of `vitron_tpu/core/distributed.py`. The JAX package has one
controller process that drives every chip (`jax.distributed.initialize`
wires hosts into one runtime). Here every GPU has a process of its own
under `torch.distributed`: NCCL between cards, gloo between CPU processes
(the tests), and each rank runs the same programs in the same order with
the collectives written out (`core/mesh.py`).

The env protocol is the JAX package's: COORDINATOR_ADDRESS first, then
MASTER_ADDR / MASTER_PORT (torchrun, the reference's i2vgen launcher),
NUM_PROCESSES / WORLD_SIZE, and PROCESS_ID / RANK / OMPI_COMM_WORLD_RANK
(SEEM's MPI detection). Under torchrun (MASTER_ADDR set, no coordinator)
the group joins torchrun's own store (`env://`); a coordinator address
makes rank 0 host a TCP store there.

A process runs on `cuda:LOCAL_RANK` with NCCL unless the caller asks for
gloo (`backend="gloo"`, the CPU).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

DEFAULT_PORT = "8476"


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Explicit override of the env protocol (None -> read the env).
    `init_method` (a `file://` or `tcp://` URL) replaces the address."""

    coordinator_address: Optional[str] = None   # "host:port"
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[tuple] = None
    init_method: Optional[str] = None

    @staticmethod
    def from_env() -> "DistributedConfig":
        """Read the env protocol: COORDINATOR_ADDRESS etc. take precedence
        over the reference's MASTER_ADDR / WORLD_SIZE / RANK names."""
        addr = os.environ.get("COORDINATOR_ADDRESS")
        if addr is None and os.environ.get("MASTER_ADDR"):
            addr = (os.environ["MASTER_ADDR"] + ":"
                    + os.environ.get("MASTER_PORT", DEFAULT_PORT))
        nproc = os.environ.get("NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
        pid = os.environ.get("PROCESS_ID")
        if pid is None:
            pid = (os.environ.get("RANK")
                   or os.environ.get("OMPI_COMM_WORLD_RANK"))
        return DistributedConfig(
            coordinator_address=addr,
            num_processes=int(nproc) if nproc else None,
            process_id=int(pid) if pid is not None else None,
        )


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("OMPI_COMM_WORLD_LOCAL_RANK", "0")))


def _init_method(cfg: DistributedConfig) -> str:
    if cfg.init_method is not None:
        return cfg.init_method
    if ("COORDINATOR_ADDRESS" not in os.environ and os.environ.get("MASTER_ADDR")
            and os.environ.get("MASTER_PORT")
            and cfg.coordinator_address == (os.environ["MASTER_ADDR"] + ":"
                                            + os.environ["MASTER_PORT"])):
        return "env://"  # torchrun's store
    return f"tcp://{cfg.coordinator_address}"


def initialize(cfg: Optional[DistributedConfig] = None, backend: Optional[str] = None,
               timeout_s: float = 1800.0) -> bool:
    """Join the process group once; safe to call in a single process.

    Returns True when a group is up (made here or before), False for a plain
    single process: no coordinator, no init_method. backend: "nccl" (the
    default: this rank's card is `cuda:LOCAL_RANK`, and no CUDA device is an
    error) or "gloo" (CPU processes). Idempotent."""
    if dist.is_initialized():
        return True
    cfg = cfg or DistributedConfig.from_env()
    if cfg.coordinator_address is None and cfg.init_method is None:
        return False
    if cfg.num_processes is None or cfg.process_id is None:
        raise ValueError(f"a process group needs its world size and rank: {cfg}")
    backend = backend or "nccl"
    kw = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend nccl needs a CUDA device; pass backend='gloo' "
                               "to run on the CPU")
        ids = cfg.local_device_ids
        device = torch.device("cuda", ids[0] if ids else local_rank())
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=_init_method(cfg),
                            world_size=cfg.num_processes, rank=cfg.process_id,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def device() -> torch.device:
    """This rank's device: its card under NCCL, the CPU under gloo (and in
    a single process without a group, the CPU too)."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_info() -> dict:
    """Rank / world-size view (the reference's get_rank / get_world_size)."""
    up = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": dist.get_world_size() if up else 1,
        "local_devices": 1,
        "global_devices": dist.get_world_size() if up else 1,
        "initialized": up,
    }


def is_primary() -> bool:
    """The rank-0 gate (reference rank0_print, train.py:48-50)."""
    return not dist.is_initialized() or dist.get_rank() == 0
