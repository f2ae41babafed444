"""The port's sharded train step (A16b) against the JAX package's on the CPU.

JAX runs `make_train_step` jitted over params placed by
`VITRON_SHARDING_RULES` on its 8-device CPU mesh (tests/conftest.py), the
batch's rows on `data`, as its dryrun's train leg does
(`__graft_entry__._dryrun_multichip_impl`). The port runs the same step on
gloo ranks (tests/torch_dist.py, bodies in tests/torch_train_bodies.py)
from the same initial tree and the same example batch:

- each autograd collective (`Shard.gather`, `gather_params`, Megatron's
  "f" and "g" around a column / row pair, `tensor_parallel.linear`'s vocab
  split, the sharded embedding lookup) on 2 and 4 ranks: the output and the
  gradients of a fixed random projection of it against the same op on the
  full tensors, within 1e-6 relative (float32 partial sums);
- the unfiltered step at {tensor 2} on 2 ranks and {data 2, tensor 2},
  {fsdp 2, tensor 2}, {data 2, fsdp 2} on 4, for 2 steps, against the
  port's step without a mesh: the loss on every rank (1e-4 relative), step
  1's gradients before the clip, gathered (1e-4 of each leaf's largest:
  AdamW and the clip would hide a gradient scaled by a constant), the
  clip's norm (1e-5 relative), the leaves after step 2 (5e-5), and every
  block bit-equal on the ranks that hold it;
- the same runs against JAX: the loss on every rank against JAX's sharded
  step at the same mesh shape (1e-4 relative), the gradients against
  `jax.grad` of the same loss and the norm against `optax.global_norm`
  (1e-3: see below), the leaves after step 2 against JAX's (5e-5, but for
  at most 1 in 1,000 elements of a leaf, those within 4 lr);
- a one-rank mesh (every collective issued) bit-equal to the port's step
  without a mesh, in float32.
The steps run in float64 on both sides; the attention softmaxes and the
loss's log-softmax stay float32, as in both packages. This config's
gradients are ill-conditioned: in float32 JAX's own are up to 1e-3 of a
leaf's largest away from its float64 ones, and in float64 the float32
roundings of the two packages, made in different places, leave the
gradients up to 4e-4 apart (the norm 1.7e-4). The key biases' gradients
are 0 in exact arithmetic and rounding noise on both sides (held below
1e-5 of the tree's largest), and AdamW turns noise into updates of +-lr,
so an element whose gradient lies within the noise may move the other
way. The example batch's two rows hold different counts of supervised
tokens, so a rank that divided by its own count would fail the losses.
JAX's five programs compile in threads while the ranks run.
"""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import __graft_entry__ as graft
from vitron_tpu.core import mesh as jm
from vitron_tpu.models import vitron_model as jvm
from vitron_tpu.train import train_step as jstep
from vitron_tpu.train.losses import causal_lm_loss
from vitron_tpu_torch.apps import dryrun_multichip as dm
from vitron_tpu_torch.core.mesh import Shard
from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.train import train_step as tstep

import torch_dist
import torch_train_bodies
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MESHES = {2: [{"tensor": 2}],
          4: [{"data": 2, "tensor": 2}, {"fsdp": 2, "tensor": 2}, {"data": 2, "fsdp": 2}]}
CASES = [(n, i) for n, shapes in MESHES.items() for i in range(len(shapes))]
COLLECTIVE_TOL = 1e-6  # relative, float32 partial sums in another order
LR = 1e-4              # the dryrun's AdamW
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-4        # max |sharded - plain| / max |plain| per leaf
NORM_RTOL = 1e-5
LEAF_ATOL = 5e-5
JAX_GRAD_TOL = 1e-3    # max |port - JAX| / max |JAX| per leaf, and the norm's
ZERO_GRAD = 1e-5       # of the tree's largest: a gradient 0 in exact arithmetic
LEAF_OUTLIERS = 1e-3   # the share of a leaf's elements past LEAF_ATOL of JAX's
ROW_KEYS = ("token_ids", "media_idx", "use_media", "positions", "attn_mask", "labels")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _float64():
    """The dryrun's config, params and batch in float64 (call under x64)."""
    cfg = graft._tiny_cfg()

    def wide(c):
        return dataclasses.replace(c, param_dtype=jnp.float64, compute_dtype=jnp.float64)

    cfg = dataclasses.replace(cfg, llm=wide(cfg.llm), image_tower=wide(cfg.image_tower),
                              video_tower=wide(cfg.video_tower))
    params = jax.tree.map(lambda a: a.astype(jnp.float64),
                          jvm.init_params(jax.random.PRNGKey(0), cfg))
    batch = {k: v.astype(jnp.float64) if v is not None and v.dtype == jnp.float32 else v
             for k, v in graft._example_batch(cfg, batch=2, pad_len=128).items()}
    return cfg, params, batch


def _jax_grads(cfg, params, batch):
    """jax.grad of the dryrun step's loss -> (gradients, optax.global_norm)."""
    def loss_fn(p):
        logits, _ = jvm.forward(
            p, cfg, batch["token_ids"], batch["media_idx"], batch["use_media"],
            batch["positions"], batch["attn_mask"], images=batch["images"],
            videos=batch["videos"], block_perm=batch["block_perm"],
            region_boxes=batch["region_boxes"], region_block_idx=batch["region_block_idx"])
        return causal_lm_loss(logits, batch["labels"])

    with jax.enable_x64(True):
        grads = jax.jit(jax.grad(loss_fn))(params)
        return _np(grads), float(optax.global_norm(grads))


def _jax_steps(cfg, params, batch, shape, n):
    """JAX's dryrun train step, 2 steps on an n-device mesh of `shape` ->
    (losses, the leaves after them)."""
    with jax.enable_x64(True):
        mesh = jm.create_mesh(shape, devices=jax.devices()[:n])
        params = jm.shard_params(params, mesh, jvm.VITRON_SHARDING_RULES)
        opt = jstep.make_optimizer(lr=LR)
        state = jax.jit(opt.init)(params)
        step = jax.jit(jstep.make_train_step(cfg, opt))
        batch = dict(batch)
        for k in ROW_KEYS:
            batch[k] = jax.device_put(batch[k], NamedSharding(mesh, P("data")))
        losses = []
        for _ in range(2):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
        return losses, _np(params)


def _port_plain(params_np):
    """The port's step without a mesh, 2 float64 steps -> (losses, step 1's
    gradients, the clip's norm, the leaves after them)."""
    cfg = torch_train_bodies.tiny_vitron(torch.float64)
    batch = torch_train_bodies.example_batch(cfg)
    params = from_jax(params_np, "cpu")
    opt = tstep.make_optimizer(tstep.set_trainable(params), lr=LR)
    step = tstep.make_train_step(cfg, opt)
    grads = {}
    losses = [float(step(params, batch, grads=grads))]
    norm = float(opt.states[0][0]["norm"])
    losses.append(float(step(params, batch)))
    leaves = dict(tstep.named_leaves(params))
    return {"losses": losses, "norm": norm,  # a leaf the loss does not reach: a zero gradient
            "grads": {p: (grads[p] if p in grads else torch.zeros_like(t)).numpy()
                      for p, t in leaves.items()},
            "params": {p: t.detach().numpy() for p, t in leaves.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's gradients and sharded steps (compiled in threads) beside the
    ranks' runs and the port's step without a mesh."""
    with jax.enable_x64(True):
        cfg, params, batch = _float64()
    params_np = _np(params)
    plain = _port_plain(params_np)
    with ThreadPoolExecutor(len(CASES) + 1) as pool:
        grads = pool.submit(_jax_grads, cfg, params, batch)
        steps = {(n, i): pool.submit(_jax_steps, cfg, params, batch, MESHES[n][i], n)
                 for n, i in CASES}
        ranks = {n: torch_dist.run(n, "torch_train_bodies:run", params_np, MESHES[n],
                                   tmp=tmp_path_factory.mktemp(f"pg{n}"), timeout=600)
                 for n in MESHES}
        grads, norm = grads.result()
        return {"params": params_np, "grads": grads, "norm": norm, "ranks": ranks,
                "plain": plain, "steps": {c: f.result() for c, f in steps.items()}}


def test_example_batch_matches_jax_and_splits_unevenly():
    want = graft._example_batch(graft._tiny_cfg(), batch=2, pad_len=128)
    got = dm.example_batch(dm.tiny_vitron(), "cpu")
    assert sorted(got) == sorted(k for k, v in want.items() if v is not None)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=k)
    supervised = (got["labels"][:, 1:] != -100).sum(dim=1).tolist()
    assert supervised[0] != supervised[1], supervised


@pytest.mark.parametrize("n", sorted(MESHES))
def test_collectives_carry_gradients(runs, n):
    for out in runs["ranks"][n]:
        assert max(out["collectives"].values()) <= COLLECTIVE_TOL, out["collectives"]


def _rel_errors(got: dict, want: dict) -> dict:
    assert set(got) == set(want)
    return {p: float(np.abs(g - want[p]).max()) / max(float(np.abs(want[p]).max()), 1e-300)
            for p, g in got.items()}


@pytest.mark.parametrize("n,case", CASES)
def test_sharded_step_matches_the_plain_step(runs, n, case):
    plain = runs["plain"]
    outs = [r["steps"][case] for r in runs["ranks"][n]]
    for out in outs:
        np.testing.assert_allclose(out["losses"], plain["losses"], rtol=LOSS_RTOL)
        assert abs(out["norm"] - plain["norm"]) <= NORM_RTOL * plain["norm"]
    errs = _rel_errors(outs[0]["grads"], plain["grads"])
    assert max(errs.values()) <= GRAD_TOL, max(errs.items(), key=lambda kv: kv[1])
    for path, leaf in outs[0]["params"].items():
        np.testing.assert_allclose(leaf, plain["params"][path], rtol=0, atol=LEAF_ATOL,
                                   err_msg=str(path))
    start = dict(tstep.named_leaves(runs["params"]))
    assert not np.array_equal(outs[0]["params"][("image_tower", "patch_proj")],
                              start[("image_tower", "patch_proj")])
    holders = {}
    for out in outs:
        for path, (coords, digest) in out["blocks"].items():
            holders.setdefault((path, coords), set()).add(digest)
    assert all(len(d) == 1 for d in holders.values()), \
        [k for k, d in holders.items() if len(d) > 1]


@pytest.mark.parametrize("n,case", CASES)
def test_sharded_step_matches_jax(runs, n, case):
    want_losses, want_params = runs["steps"][(n, case)]
    outs = [r["steps"][case] for r in runs["ranks"][n]]
    for out in outs:
        np.testing.assert_allclose(out["losses"], want_losses, rtol=LOSS_RTOL)
        assert abs(out["norm"] - runs["norm"]) <= JAX_GRAD_TOL * runs["norm"]
    want = dict(tstep.named_leaves(runs["grads"]))
    largest = max(float(np.abs(w).max()) for w in want.values())
    zero = {p for p, w in want.items() if float(np.abs(w).max()) <= ZERO_GRAD * largest}
    got = outs[0]["grads"]
    assert all(float(np.abs(got[p]).max()) <= ZERO_GRAD * largest for p in zero)
    errs = _rel_errors({p: g for p, g in got.items() if p not in zero},
                       {p: w for p, w in want.items() if p not in zero})
    assert max(errs.values()) <= JAX_GRAD_TOL, max(errs.items(), key=lambda kv: kv[1])
    want_leaves = dict(tstep.named_leaves(want_params))
    for path, leaf in outs[0]["params"].items():
        diff = np.abs(leaf - want_leaves[path])
        assert float(diff.max()) <= 4 * LR, (path, float(diff.max()))
        assert (diff > LEAF_ATOL).mean() <= LEAF_OUTLIERS, (path, int((diff > LEAF_ATOL).sum()))


def test_one_rank_mesh_is_bit_equal_to_the_plain_step(tmp_path):
    params = _np(jvm.init_params(jax.random.PRNGKey(0), graft._tiny_cfg()))
    out, = torch_dist.run(1, "torch_train_bodies:one_rank_matches_plain", params, tmp=tmp_path)
    assert out["mesh"] == out["plain"]
    assert out["differ"] == []


def test_factored_transform_refuses_a_shard():
    leaf = Shard(torch.zeros((256, 256)), ("fsdp", None), (512, 256), mesh=None)
    with pytest.raises(NotImplementedError, match="factored"):
        tstep.Optimizer([([leaf], tstep.adafactor(1e-3))])
    tstep.Optimizer([([leaf], tstep.adamw(1e-3))])
