"""Rank bodies of the sharded train step's tests (run by tests/torch_dist.py).

Each function runs on every rank of a gloo group of CPU processes, imports
torch and the port only (no JAX), takes numpy inputs and returns numpy
arrays, numbers and strings, which `tests/test_torch_sharded_train.py`
holds against the JAX package computed in the test process.
"""
import dataclasses
import hashlib

import torch
import torch.nn.functional as F

from vitron_tpu_torch.apps import dryrun_multichip as dm
from vitron_tpu_torch.core import mesh as cm
from vitron_tpu_torch.distributed import tensor_parallel as tp
from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.train import train_step as ts

STEPS = 2


def _rand(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _grads(fn, *xs):
    """(fn's output, the gradients of a fixed random projection of it with
    respect to each x)."""
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    (out * _rand(out.shape, 99)).sum().backward()
    return out.detach(), [x.grad for x in xs]


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def collective_grads(shape) -> dict:
    """Each autograd collective on `shape`'s mesh against the same op on the
    full tensors: the output and every gradient (a Shard's block against
    the block of the full gradient) -> {op: the largest relative error}."""
    mesh = cm.create_mesh(shape)
    t = cm.TENSOR_AXIS
    tgroup = mesh.group(t)

    def block(full, spec):
        return cm.shard_tensor(full, spec, mesh).local

    def errors(sharded, plain, specs, *full):
        """sharded(*blocks) and plain(*full): the output and each input's
        gradient, a block held against the full gradient's block."""
        out, grads = _grads(sharded, *(block(x, s) if s else x for x, s in zip(full, specs)))
        want, want_grads = _grads(plain, *full)
        errs = [_rel(out, want)]
        errs += [_rel(g, block(w, s) if s else w) for g, w, s in zip(grads, want_grads, specs)]
        return max(errs)

    def shard(local, spec, full):
        return cm.Shard(local, spec, tuple(full.shape), mesh)

    w = _rand((8, 12), 1)
    spec_w = cm.fit_spec((cm.FSDP_AXIS, t), tuple(w.shape), mesh)
    x = _rand((3, 8), 2)
    w1, w2 = _rand((8, 16), 3), _rand((16, 8), 4)
    col = cm.fit_spec((cm.FSDP_AXIS, t), (8, 16), mesh)
    row = cm.fit_spec((t, cm.FSDP_AXIS), (16, 8), mesh)
    head = _rand((8, 20), 5)
    spec_head = cm.fit_spec((cm.FSDP_AXIS, t), (8, 20), mesh)
    table = _rand((20, 8), 6)
    spec_tab = cm.fit_spec((t, cm.FSDP_AXIS), (20, 8), mesh)
    ids = torch.tensor([[0, 19, 7, 7, 12], [3, 10, 10, 10, 1]])

    def megatron(x, a, b):
        xa = tp.copy_to_group(x, tgroup) @ tp.gather(shard(a, col, w1), (t,))
        return tp.row_linear(F.silu(xa), tp.gather(shard(b, row, w2), (t,)), tgroup)

    return {
        "gather": errors(lambda a: shard(a, spec_w, w).gather(), lambda a: a * 1.0,
                         [spec_w], w),
        "gather_params": errors(lambda a: cm.gather_params({"w": shard(a, spec_w, w)})["w"],
                                lambda a: a * 1.0, [spec_w], w),
        "megatron_mlp": errors(megatron, lambda x, a, b: F.silu(x @ a) @ b, [None, col, row],
                               x, w1, w2),
        "linear": errors(lambda x, a: tp.linear(x, shard(a, spec_head, head)),
                         lambda x, a: x @ a, [None, spec_head], x, head),
        "lookup": errors(lambda a: shard(a, spec_tab, table)[ids], lambda a: a[ids],
                         [spec_tab], table),
    }


def tiny_vitron(dtype=torch.float32):
    """The dryrun's tiny Vitron with its LLM and towers in `dtype`."""
    cfg = dm.tiny_vitron()

    def wide(c):
        return dataclasses.replace(c, param_dtype=dtype, compute_dtype=dtype)

    return dataclasses.replace(cfg, llm=wide(cfg.llm), image_tower=wide(cfg.image_tower),
                               video_tower=wide(cfg.video_tower))


def example_batch(cfg):
    """The dryrun's example batch, its media in the towers' dtype."""
    batch = dm.example_batch(cfg, "cpu")
    return {k: v.to(cfg.image_tower.param_dtype) if v.is_floating_point() else v
            for k, v in batch.items()}


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().numpy().tobytes()).hexdigest()


def sharded_steps(params_np, shape) -> dict:
    """STEPS unfiltered steps of the dryrun's train step on `shape`'s mesh
    from the float64 tree `params_np`, in float64: every rank's losses and
    clip norm, the block of each leaf by its coordinates on the axes that
    cut it (a sha1 of its bytes after the last step), and on rank 0 the
    step-1 gradients and the final leaves, gathered."""
    mesh = cm.create_mesh(shape)
    cfg = tiny_vitron(torch.float64)
    batch = example_batch(cfg)
    params = cm.shard_params(from_jax(params_np, "cpu"), mesh,
                             vitron_model.VITRON_SHARDING_RULES)
    opt = ts.make_optimizer(ts.set_trainable(params), lr=1e-4)
    step = ts.make_train_step(cfg, opt)
    grads = {}
    losses = [float(step(params, batch, grads=grads))]
    norm = float(opt.states[0][0]["norm"])
    losses += [float(step(params, batch)) for _ in range(STEPS - 1)]
    leaves = dict(ts.named_leaves(params))
    full_grads = {p: cm.Shard(g, leaves[p].spec, leaves[p].shape, mesh).full().numpy()
                  for p, g in grads.items()}
    full = {p: leaf.full().detach().numpy() for p, leaf in leaves.items()}
    blocks = {p: (tuple((ax, mesh.index(ax)) for ax in leaf.spec if ax is not None),
                  _digest(leaf.local)) for p, leaf in leaves.items()}
    first = torch.distributed.get_rank() == 0
    return {"losses": losses, "blocks": blocks, "norm": norm,
            "grads": full_grads if first else None, "params": full if first else None}


def one_rank_matches_plain(params_np) -> dict:
    """STEPS unfiltered steps on a one-rank mesh (every collective issued)
    and without one, from the same tree -> the losses and the leaves that
    differ in any bit."""
    cfg = tiny_vitron()
    batch = example_batch(cfg)
    plain = from_jax(params_np, "cpu")
    mesh = cm.create_mesh({cm.DATA_AXIS: 1})
    sharded = cm.shard_params(from_jax(params_np, "cpu"), mesh,
                              vitron_model.VITRON_SHARDING_RULES)
    out = {}
    for name, tree in (("plain", plain), ("mesh", sharded)):
        step = ts.make_train_step(cfg, ts.make_optimizer(ts.set_trainable(tree), lr=1e-4))
        out[name] = [float(step(tree, batch)) for _ in range(STEPS)]
    got = dict(ts.named_leaves(cm.gather_params(sharded)))
    out["differ"] = [p for p, t in ts.named_leaves(plain) if not torch.equal(got[p], t)]
    return out


def run(params_np, shapes) -> dict:
    """The collectives at the mesh of the world's fsdp x tensor split, then
    the train steps at each mesh shape."""
    n = torch.distributed.get_world_size()
    return {"collectives": collective_grads({cm.FSDP_AXIS: n // 2, cm.TENSOR_AXIS: 2}),
            "steps": [sharded_steps(params_np, s) for s in shapes]}
