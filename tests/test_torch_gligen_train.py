"""The port's GLIGEN grounded trainer (`vitron_tpu_torch/train/gligen.py`)
against the JAX package's (`vitron_tpu/train/gligen.py`).

- `trainable_mask` and `partition_params` on the full key paths of a
  grounded UNet, the 9-channel inpainting variant with and without
  `input_conv_train` included;
- the optimizer chain (clip_by_global_norm, AdamW) against optax's
  multi_transform over three steps;
- whole training steps at a single-level `UNetConfig.tiny()` (16x16
  latents, 4 boxes), fed JAX's own draws (the whole-batch grounding drop, t and the
  noise, split from the step's key as JAX splits it): the loss, every
  trainable gradient and the updated parameters after each of two steps,
  the first with the grounding dropped. JAX's step is jitted once (its
  gradients come out of an optax stage chained before the optimizer that
  keeps them in its state).

Tolerances: the loss within 1e-5 of JAX's, each gradient within 1e-4 of the
larger of its largest |JAX| element and 5e-2 of the step's largest gradient
element (float32 on both sides; the UNet's sums run in other orders, and a
gradient that is a sum with heavy cancellation, such as a fuser gate's
scalar, or that vanishes in exact arithmetic, holds float noise of its
terms' size, not of its own). The updated parameters are held against optax's optimizer (JAX's
make_optimizer) applied to the port's own gradients, within 1e-6 of each
tensor's largest element: with the gradients within their limit, that
holds the whole step. They are not held element by element against JAX's
step, since AdamW's first steps move an element by lr m / (sqrt(v) + 1e-8),
which float32 gradient differences swing where |g| is near 1e-8 (up to 6%
of lr in this test).
"""
import dataclasses

import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion import unet2d as tunet
from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule as TSched
from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
from vitron_tpu_torch.train import gligen as tg
from vitron_tpu_torch.train import train_step as ts
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 5e-2
PARAM_TOL = 1e-6
LR = 1e-3


def _jax_key(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _jax_paths(tree):
    """{key path: leaf} of a JAX tree, keys as the port names them."""
    import jax

    return {_jax_key(path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _live_unet(cfg, seed):
    """(JAX params, port params) of one grounded UNet: the port's init (the
    JAX init's keys and shapes) with its zero leaves filled, carried to JAX."""
    import jax
    import jax.numpy as jnp

    tree = fill_zero_leaves(tunet.init_params(torch.Generator().manual_seed(seed), cfg, "cpu"),
                            torch.Generator().manual_seed(seed + 1))
    return jax.tree.map(jnp.asarray, _to_numpy(tree)), tree


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.detach().numpy().copy()


@pytest.mark.parametrize("in_channels,input_conv_train", [(4, False), (9, False), (9, True)])
def test_trainable_mask_matches_jax(in_channels, input_conv_train):
    """The same leaves train on every key path; the 9-channel variant's
    first conv (input_blocks.0.0) only with input_conv_train."""
    from vitron_tpu.train import gligen as jg

    cfg = tunet.UNetConfig.tiny(in_channels=in_channels)
    tparams = tunet.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    jparams = _to_numpy(tparams)  # the same tree as numpy leaves for JAX's mask
    jcfg = jg.GligenTrainConfig(input_conv_train=input_conv_train)
    tcfg = tg.GligenTrainConfig(input_conv_train=input_conv_train)
    want = _jax_paths(jg.trainable_mask(jparams, jcfg))
    got = dict(ts.named_leaves(tg.trainable_mask(tparams, tcfg)))
    assert got == want
    assert any(got.values()) and not all(got.values())
    assert got[("input_blocks", 0, 0, "w")] == input_conv_train
    assert tg.partition_params(tparams, tcfg) == jg.partition_params(jparams, jcfg)
    assert [p for p, _ in tg.trainable_leaves(tparams, tcfg)] == [p for p, m in got.items() if m]


def test_optimizer_matches_optax():
    """clip_by_global_norm(1.0) + AdamW over the trainable leaves against
    JAX's multi_transform (set_to_zero on the frozen ones), three steps,
    norms below and above the clip."""
    import jax
    import jax.numpy as jnp
    import optax

    from vitron_tpu.train import gligen as jg

    rs = np.random.RandomState(0)
    params = {"fuser": {"w": rs.randn(6, 5), "b": rs.randn(5)}, "conv": {"w": rs.randn(3, 3)},
              "position_net": {"w": rs.randn(4, 7)}}
    jcfg = jg.GligenTrainConfig(lr=1e-2, weight_decay=0.05, grad_clip_norm=1.0)
    tcfg = tg.GligenTrainConfig(lr=1e-2, weight_decay=0.05, grad_clip_norm=1.0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    opt = jg.make_optimizer(jp, jcfg)
    state = opt.init(jp)
    tp = from_jax(jax.tree.map(lambda a: a.astype(np.float32), params), "cpu")
    leaves = [p for _, p in tg.trainable_leaves(tp, tcfg)]
    tx = tg.make_optimizer(tcfg)
    tstate = tx.init(leaves)
    for scale in (0.01, 10.0, 0.3):
        g = jax.tree.map(lambda a: (scale * rs.randn(*a.shape)).astype(np.float32), params)
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for path, p in tg.trainable_leaves(tp, tcfg):
            p.grad = torch.from_numpy(_jax_paths(g)[path])
        tstate = ts.apply_gradients(tx, leaves, tstate)
        want = _jax_paths(jp)
        for path, p in ts.named_leaves(tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(want[path]), rtol=1e-6, atol=1e-6,
                                       err_msg=str(path))


def _batch(cfg, b=2, hw=16, max_box=4, seed=0):
    r = np.random.RandomState(seed)
    return {"x0": r.randn(b, hw, hw, 4).astype(np.float32),
            "context": r.randn(b, 8, cfg.context_dim).astype(np.float32),
            "boxes": r.rand(b, max_box, 4).astype(np.float32),
            "masks": np.array([[1, 1, 1, 0], [1, 0, 1, 1]], np.float32),
            "phrase_emb": r.randn(b, max_box, cfg.context_dim).astype(np.float32)}


def _jax_draws(rng, x0, p_drop, num_timesteps):
    """The draws JAX's loss_fn makes from a step's key (gligen.py:105-117)."""
    import jax

    d_rng, l_rng, t_rng = jax.random.split(rng, 3)
    return {"drop": torch.tensor(bool(jax.random.uniform(d_rng, ()) < p_drop)),
            "t": torch.tensor(np.asarray(jax.random.randint(t_rng, (x0.shape[0],), 0,
                                                            num_timesteps)), dtype=torch.long),
            "noise": torch.tensor(np.asarray(jax.random.normal(l_rng, x0.shape)))}


def _keys(p_drop):
    """Two step keys: the first drops the grounding, the second keeps it."""
    import jax

    drops = [bool(jax.random.uniform(jax.random.split(jax.random.PRNGKey(i), 3)[0], ())
                  < p_drop) for i in range(200)]
    return [jax.random.PRNGKey(drops.index(True)), jax.random.PRNGKey(drops.index(False))]


def _recording(inner):
    """optax: an identity stage that keeps the gradients in its state,
    chained before `inner`."""
    import jax
    import optax

    keep = optax.GradientTransformation(lambda p: jax.tree.map(lambda a: a * 0, p),
                                        lambda u, s, p=None: (u, u))
    return optax.chain(keep, inner)


def test_gligen_steps_match_jax():
    import jax
    import optax

    from vitron_tpu.models.diffusion import unet2d as junet
    from vitron_tpu.models.diffusion.samplers import DiffusionSchedule as JSched
    from vitron_tpu.train import gligen as jg

    cfg = tunet.UNetConfig.tiny(channel_mult=(1,), attention_resolutions=(1,))
    jparams, tparams = _live_unet(cfg, 3)
    jcfg, tcfg = jg.GligenTrainConfig(lr=LR), tg.GligenTrainConfig(lr=LR)
    jsched, tsched = JSched.create(timesteps=50), TSched.create(timesteps=50)
    jstep, jinit = jg.make_gligen_train_step(
        junet.UNetConfig(**dataclasses.asdict(cfg)), jsched, jcfg,
        optimizer=_recording(jg.make_optimizer(jparams, jcfg)))
    jstate = jinit(jparams)
    jstep = jax.jit(jstep)
    jopt = jg.make_optimizer(jparams, jcfg)

    @jax.jit
    def optax_on(g, s, p):  # optax fed the port's gradients
        u, s = jopt.update(g, s, p)
        return s, optax.apply_updates(p, u)

    pstate, pparams = jopt.init(jparams), jparams
    tstep, tinit = tg.make_gligen_train_step(cfg, tsched, tcfg)
    tstate = tinit(tparams)
    batch = _batch(cfg)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    mask = dict(ts.named_leaves(tg.trainable_mask(tparams, tcfg)))
    frozen_before = {p: t.clone() for p, t in ts.named_leaves(tparams) if not mask[p]}
    for i, key in enumerate(_keys(tcfg.p_drop_grounding)):
        draws = _jax_draws(key, batch["x0"], tcfg.p_drop_grounding, 50)
        assert bool(draws["drop"]) == (i == 0)
        before = {p: t.detach().clone() for p, t in ts.named_leaves(tparams) if mask[p]}
        jstate, jloss = jstep(jstate, batch, key)
        grads = {}
        tstate, tloss = tstep(tstate, tbatch, draws, grads)
        assert abs(float(tloss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss)), i
        jgrads = _jax_paths(jstate["opt_state"][0])
        assert sorted(grads) == sorted(p for p, m in mask.items() if m)
        top = max(np.abs(np.asarray(jgrads[path])).max() for path in grads)
        for path, g in grads.items():
            w = np.asarray(jgrads[path])
            err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), GRAD_FLOOR * top)
            assert err <= GRAD_TOL, (i, path, err)
        port_g = jax.tree_util.tree_map_with_path(
            lambda kp, a: np.asarray(grads.get(_jax_key(kp), torch.zeros(a.shape))), pparams)
        pstate, pparams = optax_on(port_g, pstate, pparams)
        derived = _jax_paths(pparams)
        for path, t in ts.named_leaves(tstate["params"]):
            got, d = t.detach().numpy(), np.asarray(derived[path])
            assert np.abs(got - d).max() <= PARAM_TOL * np.abs(d).max(), (i, path)
            if mask[path]:
                assert not torch.equal(t.detach(), before[path]), (i, path)
    assert all(torch.equal(t, frozen_before[p])
               for p, t in ts.named_leaves(tstate["params"]) if not mask[p])


def test_generator_draws_and_frozen_leaves():
    """A step from a torch.Generator: the drop is one draw for the whole
    batch, t in [0, T), the noise x0's shape; frozen tensors take no
    gradient and no optimizer state."""
    cfg = tunet.UNetConfig.tiny()
    params = fill_zero_leaves(tunet.init_params(torch.Generator().manual_seed(0), cfg, "cpu"),
                              torch.Generator().manual_seed(1))
    sched = TSched.create(timesteps=50)
    tcfg = tg.GligenTrainConfig()
    x0 = torch.zeros(3, 8, 8, 4)
    d = tg.draw(torch.Generator().manual_seed(2), x0, sched, tcfg)
    assert d["drop"].shape == () and d["t"].shape == (3,) and d["noise"].shape == x0.shape
    assert int(d["t"].min()) >= 0 and int(d["t"].max()) < 50
    step, init = tg.make_gligen_train_step(cfg, sched, tcfg)
    state = init(params)
    n_train = sum(p.numel() for _, p in tg.trainable_leaves(params, tcfg))
    assert sum(m.numel() for m in state["opt_state"][0][0]["mu"]) == n_train
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg, hw=8).items()}
    state, loss = step(state, b, torch.Generator().manual_seed(3))
    assert np.isfinite(float(loss))
    assert all(p.grad is None for p in ts.leaves(params))
    assert all(not p.requires_grad for path, p in ts.named_leaves(params)
               if not tg._is_trainable(path, False))
