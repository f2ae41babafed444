"""The port's video-UNet trainer (`vitron_tpu_torch/train/video.py`), its
losses (`models/diffusion/losses.py`) and optimizer chains against the JAX
package's.

- `diffusion_loss` for every mean type (eps, x0, v) and loss type (mse,
  l1, charbonnier), with a per-sample weight and with the div loss, on JAX's
  own noise; `v_to_eps`;
- `annealing_lr` in every decay mode, `ema_update`;
- the optimizer chains against optax over several steps: the value clip
  then AdamW at `annealing_lr` (the trainer's default), and Adafactor on
  1-D, small, factored and 3-D shapes whose largest dims are not the last
  two;
- whole training steps at single-level tiny video UNets with transformers
  in the init and middle blocks only (t2v, and i2vgen with its fps, image
  and local-image extras), fed JAX's own draws (the
  per-row text drop, t and the noise, split from each step's key as JAX
  splits it): the loss, every gradient, and the updated parameters and EMA
  after each of two steps (the first at the warmup's learning rate 0). JAX's
  step is jitted once per variant (its gradients come out of an optax stage
  chained before the optimizer that keeps them in its state).

Tolerances: losses and optimizer chains 1e-5 relative (float32 on both
sides); gradients 1e-4 of the larger of each tensor's largest |JAX|
element and 5e-2 of the step's largest gradient element (the UNet's sums
run in other orders; a gradient that is a sum with heavy cancellation, or
that vanishes in exact arithmetic, such as a bias that a one-channel-a-group
norm takes out, holds float noise of its terms' size, not of its own);
the updated parameters and the EMA within 1e-6 of each tensor's largest
element of optax's optimizer applied to the port's own gradients (AdamW's
first steps swing where |g| is near its eps; see
`test_torch_gligen_train.py`).
"""
import numpy as np
import pytest
import torch

from vitron_tpu_torch.models.convert import from_jax
from vitron_tpu_torch.models.diffusion import losses as tl
from vitron_tpu_torch.models.diffusion import unet_sd_video as tusv
from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule as TSched
from vitron_tpu_torch.models.diffusion.synthetic import fill_zero_leaves
from vitron_tpu_torch.train import train_step as ts
from vitron_tpu_torch.train import video as tv
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 1e-5
GRAD_TOL = 1e-4
GRAD_FLOOR = 5e-2
PARAM_TOL = 1e-6


def _jax_key(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _jax_paths(tree):
    import jax

    return {_jax_key(path): leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree.detach().numpy().copy()


def _close(got, want, tol=RTOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30), what


# ------------------------------------------------------------------- losses


@pytest.mark.parametrize("mean_type", ["eps", "x0", "v"])
@pytest.mark.parametrize("loss_type", ["mse", "l1", "charbonnier"])
def test_diffusion_loss_matches_jax(mean_type, loss_type):
    """On a video x0 (the div loss needs frames; it only applies to eps) and
    an image x0, with and without the weight and the div loss."""
    import jax
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import losses as jl
    from vitron_tpu.models.diffusion.samplers import DiffusionSchedule as JSched

    jsched = JSched.create("cosine", 1000, zero_terminal_snr=True)
    tsched = TSched.create("cosine", 1000, zero_terminal_snr=True)
    rs = np.random.RandomState(0)
    for shape in ((2, 3, 4, 5, 4), (2, 6, 6, 4)):
        x0 = rs.randn(*shape).astype(np.float32)
        t = np.array([3, 998], np.int32)
        w = rs.rand(2).astype(np.float32)
        k = rs.randn(*shape[-1:]).astype(np.float32)
        key = jax.random.PRNGKey(7)
        noise = np.asarray(jax.random.normal(key, x0.shape))
        for weight in (None, w):
            for div in (False, True):
                want = jl.diffusion_loss(
                    lambda xt, t_: xt * jnp.asarray(k) + 0.1 * t_.reshape(-1, *[1] *
                                                                        (xt.ndim - 1)),
                    jnp.asarray(x0), jnp.asarray(t), key, jsched, mean_type, loss_type,
                    None if weight is None else jnp.asarray(weight), div)
                got = tl.diffusion_loss(
                    lambda xt, t_: xt * torch.from_numpy(k) + 0.1 * t_.reshape(
                        -1, *[1] * (xt.dim() - 1)),
                    torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(noise),
                    tsched, mean_type, loss_type,
                    None if weight is None else torch.from_numpy(weight), div)
                _close(got.numpy(), want, what=(shape, weight is None, div))


def test_v_to_eps_matches_jax():
    import jax.numpy as jnp

    from vitron_tpu.models.diffusion import losses as jl
    from vitron_tpu.models.diffusion.samplers import DiffusionSchedule as JSched

    rs = np.random.RandomState(1)
    v, xt = (rs.randn(2, 3, 4, 4, 4).astype(np.float32) for _ in range(2))
    t = np.array([0, 500], np.int32)
    want = jl.v_to_eps(jnp.asarray(v), jnp.asarray(xt), jnp.asarray(t),
                       JSched.create("cosine", 1000, zero_terminal_snr=True))
    got = tl.v_to_eps(torch.from_numpy(v), torch.from_numpy(xt), torch.from_numpy(t).long(),
                      TSched.create("cosine", 1000, zero_terminal_snr=True))
    _close(got.numpy(), want)


# ---------------------------------------------------- schedule, EMA, chains


@pytest.mark.parametrize("mode", ["linear", "cosine", "none"])
def test_annealing_lr_matches_jax(mode):
    from vitron_tpu.train import video as jv

    for warmup in (0, 10):
        kw = dict(lr=3e-5, warmup_steps=warmup, total_steps=1000, decay_mode=mode, min_lr=1e-7)
        jcfg, tcfg = jv.VideoTrainConfig(**kw), tv.VideoTrainConfig(**kw)
        for s in [0, 1, 5, 10, 11, 100, 500, 999, 1000, 1500]:
            assert tv.annealing_lr(tcfg, s) == float(jv.annealing_lr(jcfg, s)), (warmup, s)


def test_ema_update_matches_jax():
    import jax.numpy as jnp

    from vitron_tpu.train import video as jv

    rs = np.random.RandomState(2)
    ema = {"a": rs.randn(3, 4).astype(np.float32), "b": [rs.randn(5).astype(np.float32)]}
    params = {"a": rs.randn(3, 4).astype(np.float32), "b": [rs.randn(5).astype(np.float32)]}
    want = jv.ema_update({"a": jnp.asarray(ema["a"]), "b": [jnp.asarray(ema["b"][0])]},
                         {"a": jnp.asarray(params["a"]), "b": [jnp.asarray(params["b"][0])]},
                         0.9998)
    got = tv.ema_update(from_jax(ema, "cpu"), from_jax(params, "cpu"), 0.9998)
    for path, g in ts.named_leaves(got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(_jax_paths(want)[path]))


def _run_chain(jtx, ttx, shapes, steps, seed, scales):
    """Both transforms over `steps` steps of random gradients: the params
    after each (optax's update jitted once)."""
    import jax
    import jax.numpy as jnp
    import optax

    rs = np.random.RandomState(seed)
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in params]
    jstate = jtx.init(jp)
    jtx = jtx._replace(update=jax.jit(jtx.update))
    tp = [torch.tensor(p) for p in params]
    tstate = ttx.init(tp)
    for i in range(steps):
        g = [(scales[i % len(scales)] * rs.randn(*s)).astype(np.float32) for s in shapes]
        upd, jstate = jtx.update([jnp.asarray(a) for a in g], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, a in zip(tp, g):
            p.grad = torch.tensor(a)
        tstate = ts.apply_gradients(ttx, tp, tstate)
        for j, (a, b) in enumerate(zip(tp, jp)):
            _close(a.numpy(), b, what=(i, shapes[j]))


def test_value_clip_and_adamw_at_annealing_lr_match_optax():
    """The trainer's default chain: optax.clip(0.05), then AdamW at
    annealing_lr (lr 0 at count 0), gradients inside and outside the clip."""
    from vitron_tpu.train import video as jv

    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.01)
    _run_chain(jv.make_optimizer(jv.VideoTrainConfig(**kw)),
               tv.make_optimizer(tv.VideoTrainConfig(**kw)),
               [(4, 5), (7,), (2, 3, 6)], 5, 3, (0.01, 1.0))


ADAFACTOR_SHAPES = [
    (7,),               # 1-D: a full second moment
    (5, 9),             # small: not factored (a dim below 128)
    (130, 200),         # factored over the two dims
    (140, 3, 129),      # 3-D, the two largest dims 0 and 2 (not the last two)
    (129, 150, 2),      # 3-D, the largest dims first
]


def test_adafactor_matches_optax():
    """optax.adafactor at its defaults against the port's, at a constant and
    at a scheduled learning rate, six steps."""
    import optax

    from vitron_tpu.train import video as jv

    for lr in (1e-2, None):
        if lr is None:
            cfg = tv.VideoTrainConfig(lr=1e-2, warmup_steps=2, total_steps=10)
            jlr = lambda count: jv.annealing_lr(jv.VideoTrainConfig(  # noqa: E731
                lr=1e-2, warmup_steps=2, total_steps=10), count)
            tlr = lambda count: tv.annealing_lr(cfg, count)  # noqa: E731
        else:
            jlr = tlr = lr
        _run_chain(optax.adafactor(jlr), ts.adafactor(tlr), ADAFACTOR_SHAPES, 6, 4,
                   (1.0, 1e-3, 30.0))


def test_adafactor_factors_the_two_largest_dims():
    f = ts._factored_dims
    assert f((7,)) is None and f((5, 9)) is None and f((127, 300)) is None
    assert f((130, 200)) == (0, 1)
    assert f((140, 3, 129)) == (2, 0)
    assert f((129, 150, 2)) == (0, 1)
    state = ts.scale_by_factored_rms().init([torch.zeros(140, 3, 129)])
    assert tuple(state["v_row"][0].shape) == (3, 129)
    assert tuple(state["v_col"][0].shape) == (140, 3)


# --------------------------------------------------------------- the steps


def _jax_draws(rng, x0, p_zero, num_timesteps):
    """The draws JAX's loss_fn makes from a step's key (video.py:103-111)."""
    import jax

    d_rng, n_rng, t_rng = jax.random.split(rng, 3)
    b = x0.shape[0]
    return {"drop": torch.tensor(np.asarray(jax.random.uniform(d_rng, (b,)) < p_zero)),
            "t": torch.tensor(np.asarray(jax.random.randint(t_rng, (b,), 0, num_timesteps)),
                              dtype=torch.long),
            "noise": torch.tensor(np.asarray(jax.random.normal(n_rng, x0.shape)))}


def _batch(cfg, variant, b=2, f=3, hw=8, ctx=7):
    rs = np.random.RandomState(5)
    out = {"x0": (0.5 * rs.randn(b, f, hw, hw, 4)).astype(np.float32),
           "y": (0.5 * rs.randn(b, ctx, cfg.context_dim)).astype(np.float32),
           "fps": np.array([8, 16], np.int32),
           "zero_y_negative": (0.5 * rs.randn(1, ctx, cfg.context_dim)).astype(np.float32)}
    if variant == "i2vgen":
        out["image"] = rs.randn(b, cfg.y_dim).astype(np.float32)
        out["local_image"] = (0.5 * rs.randn(b, hw, hw, 4)).astype(np.float32)
    return out


def _recording(inner):
    import jax
    import optax

    keep = optax.GradientTransformation(lambda p: jax.tree.map(lambda a: a * 0, p),
                                        lambda u, s, p=None: (u, u))
    return optax.chain(keep, inner)


@pytest.mark.parametrize("variant", ["t2v", "i2vgen"])
def test_video_steps_match_jax(variant):
    import jax
    import jax.numpy as jnp
    import optax

    from vitron_tpu.models.diffusion.samplers import DiffusionSchedule as JSched
    from vitron_tpu.train import video as jv

    # one level whose res blocks carry no transformers: the init block's
    # temporal one and the middle block's spatial and temporal ones remain,
    # every module of the UNet for half the XLA compile of attn_scales (1.0,)
    cfg = tusv.UNetSDVideoConfig.tiny(variant, dim_mult=(1,), attn_scales=())
    # the port's init (JAX's keys and shapes), zero leaves filled, carried to JAX
    tparams = fill_zero_leaves(tusv.init_params(torch.Generator().manual_seed(1), cfg, "cpu"),
                               torch.Generator().manual_seed(2))
    jparams = jax.tree.map(jnp.asarray, _to_numpy(tparams))
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=100, p_zero=0.5, ema_decay=0.9)
    jcfg, tcfg = jv.VideoTrainConfig(**kw), tv.VideoTrainConfig(**kw)
    jsched = JSched.create("cosine", 1000, zero_terminal_snr=True)
    tsched = TSched.create("cosine", 1000, zero_terminal_snr=True)
    jopt = _recording(jv.make_optimizer(jcfg))
    jstep = jax.jit(jv.make_video_train_step(cfg, jsched, jcfg, jopt))
    jstate = jv.init_state(jparams, jcfg, jopt)
    tstep = tv.make_video_train_step(cfg, tsched, tcfg)
    tstate = tv.init_state(tparams, tcfg)
    popt = jv.make_optimizer(jcfg)

    @jax.jit
    def optax_on(g, s, p, e):  # optax and the EMA fed the port's gradients
        u, s = popt.update(g, s, p)
        p = optax.apply_updates(p, u)
        return s, p, jv.ema_update(e, p, jcfg.ema_decay)

    pstate, pparams, pema = popt.init(jparams), jparams, jparams
    batch = _batch(cfg, variant)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    init = {p: t.detach().clone() for p, t in ts.named_leaves(tparams)}
    for i, seed in enumerate((11, 12)):
        key = jax.random.PRNGKey(seed)
        draws = _jax_draws(key, batch["x0"], tcfg.p_zero, 1000)
        jstate, jloss = jstep(jstate, batch, key)
        grads = {}
        tstate, tloss = tstep(tstate, tbatch, draws, grads)
        assert abs(float(tloss) - float(jloss)) <= RTOL * abs(float(jloss)), i
        jgrads = _jax_paths(jstate["opt_state"][0])
        assert sorted(grads) == sorted(jgrads)
        top = max(np.abs(np.asarray(jgrads[path])).max() for path in grads)
        for path, g in grads.items():
            w = np.asarray(jgrads[path])
            err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), GRAD_FLOOR * top)
            assert err <= GRAD_TOL, (i, path, err)
        port_g = jax.tree_util.tree_map_with_path(
            lambda kp, a: np.asarray(grads[_jax_key(kp)]), pparams)
        pstate, pparams, pema = optax_on(port_g, pstate, pparams, pema)
        for tree, want in ((tstate["params"], pparams), (tstate["ema"], pema)):
            want = _jax_paths(want)
            for path, t in ts.named_leaves(tree):
                w = np.asarray(want[path])
                assert np.abs(t.detach().numpy() - w).max() <= PARAM_TOL * np.abs(w).max(), (
                    i, path)
        moved = [not torch.equal(t.detach(), init[p]) for p, t in ts.named_leaves(tparams)]
        assert (any(moved) if i else not any(moved)), i  # step 1 runs at lr 0
