"""The port's (cfg, frames)-sharded video step (`distributed/
video_sharding.py`) on gloo ranks against the JAX package's
`shard_video_step` on its virtual CPU mesh (tests/conftest.py), at
`UNetSDVideoConfig.tiny(...)` with JAX's params (their zero leaves filled
from a numpy seed, so every block reaches the output):

- t2v on the (cfg=2, frames=2) mesh on 4 ranks: the CFG pair split, two
  frames a rank with the temporal conv's halo, the (F, H, W) group-norm
  sums all-reduced and the frame attention gathered;
- t2v on the frames-only mesh (cfg_parallel=False, JAX's cfg-only case)
  on 2 ranks;
- i2vgen on the frames-only mesh on 2 ranks: the image streams' frame
  positions and their adapter transformer over the gathered frames.

Tolerance: rtol 2e-4, atol 2e-5, float32, as JAX's
tests/test_video_sharding.py (which holds JAX's sharded step to its dense
one); each rank gets the whole eps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitron_tpu.distributed import video_sharding as jvs
from vitron_tpu.models.diffusion import unet_sd_video as jusv

import torch_dist
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _inputs(variant):
    cfg = jusv.UNetSDVideoConfig.tiny(variant)
    rs = np.random.RandomState(7)
    params = jax.tree.map(lambda a: np.asarray(a) if np.asarray(a).any() else
                          (rs.randn(*np.shape(a)) * 0.05).astype(np.float32),
                          jusv.init_params(jax.random.PRNGKey(0), cfg))
    args = [rs.randn(2, 8, 8, 8, 4).astype(np.float32), np.full((2,), 3.0, np.float32),
            (rs.randn(2, 7, 1024) * 0.02).astype(np.float32)]
    if variant == "i2vgen":
        args += [np.full((2,), 8.0, np.float32),
                 rs.randn(2, cfg.y_dim).astype(np.float32),
                 rs.randn(2, 8, 8, 4).astype(np.float32)]
    return cfg, params, args


CASES = [("t2v", 4, True, {"cfg": 2, "frames": 2}),
         ("t2v", 2, False, {"cfg": 1, "frames": 2}),
         ("i2vgen", 2, False, {"cfg": 1, "frames": 2})]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's eps of each case, one gloo run a mesh shape."""
    got = {}
    for n, cfg_parallel in ((4, True), (2, False)):
        cases = [(v, *_inputs(v)[1:]) for v, n_, c, _ in CASES
                 if (n_, c) == (n, cfg_parallel)]
        outs = torch_dist.run(n, "torch_mesh_bodies:video_checks", cases, cfg_parallel,
                              tmp=tmp_path_factory.mktemp(f"video{n}"))
        for i, (v, *_) in enumerate(cases):
            got[(v, n, cfg_parallel)] = [rank[i] for rank in outs]
    return got


@pytest.mark.parametrize("variant,n,cfg_parallel,shape", CASES)
def test_sharded_step_matches_jax(ranks, variant, n, cfg_parallel, shape):
    cfg, params, args = _inputs(variant)
    mesh = jvs.create_video_mesh(n, devices=jax.devices()[:n], cfg_parallel=cfg_parallel)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == shape

    def step(p, x, t, y, *i2v):
        return jusv.forward(p, cfg, x, t, y, *i2v)

    want = np.asarray(jvs.shard_video_step(step, mesh)(jax.tree.map(jnp.asarray, params),
                                                       *(jnp.asarray(a) for a in args)))
    assert np.abs(want).max() > 0.1
    for got_shape, got in ranks[(variant, n, cfg_parallel)]:
        assert got_shape == shape
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
