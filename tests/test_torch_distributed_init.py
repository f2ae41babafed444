"""The port's process-group init (`core/distributed.py`) against the JAX
package's env protocol: the four cases of tests/test_distributed_init.py,
read by both packages from the same environment. The multi-rank path is
held by the gloo tests (tests/test_torch_mesh.py and the rest)."""
import pytest

from vitron_tpu.core import distributed as jdist
from vitron_tpu_torch.core import distributed as tdist

ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
       "WORLD_SIZE", "RANK", "OMPI_COMM_WORLD_RANK", "TPU_WORKER_HOSTNAMES",
       "MEGASCALE_COORDINATOR_ADDRESS")


def _same(monkeypatch, **env):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = jdist.DistributedConfig.from_env()
    got = tdist.DistributedConfig.from_env()
    assert (got.coordinator_address, got.num_processes, got.process_id) == (
        want.coordinator_address, want.num_processes, want.process_id)
    return got


def test_from_env_jax_names(monkeypatch):
    cfg = _same(monkeypatch, COORDINATOR_ADDRESS="10.0.0.1:1234", NUM_PROCESSES="4",
                PROCESS_ID="2")
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id) == (
        "10.0.0.1:1234", 4, 2)
    assert tdist._init_method(cfg) == "tcp://10.0.0.1:1234"


def test_from_env_torch_names(monkeypatch):
    """torchrun's names: the group joins torchrun's store (env://)."""
    cfg = _same(monkeypatch, MASTER_ADDR="10.0.0.9", MASTER_PORT="29500", WORLD_SIZE="8",
                RANK="3")
    assert (cfg.coordinator_address, cfg.num_processes, cfg.process_id) == (
        "10.0.0.9:29500", 8, 3)
    assert tdist._init_method(cfg) == "env://"


def test_from_env_mpi_rank(monkeypatch):
    cfg = _same(monkeypatch, OMPI_COMM_WORLD_RANK="1")
    assert cfg.process_id == 1 and cfg.coordinator_address is None


def test_single_host_is_noop(monkeypatch):
    """No coordinator: initialize() is False and the process runs alone;
    a group without its size is refused, and NCCL without a card too."""
    _same(monkeypatch)
    assert tdist.initialize() is False
    info = tdist.process_info()
    assert info["process_count"] == 1 and info["initialized"] is False
    assert tdist.is_primary()
    assert str(tdist.device()) == "cpu"
    with pytest.raises(ValueError, match="world size and rank"):
        tdist.initialize(tdist.DistributedConfig(init_method="file:///nonexistent"))
    monkeypatch.setattr(tdist.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        tdist.initialize(tdist.DistributedConfig(init_method="file:///nonexistent",
                                                 num_processes=1, process_id=0))
