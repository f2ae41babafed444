"""The port's mesh (`core/mesh.py`) against the JAX package's.

- `mesh_sizes` (the port's create_mesh arithmetic) against JAX's
  `create_mesh` on its 8-device virtual CPU mesh (tests/conftest.py): the
  same axis sizes, the same errors;
- `spec_for` / `fit_spec` against JAX's on every leaf of the tiny Vitron
  tree, float32 and with int4 LLM leaves ({"q4", "s"}), by the Vitron and
  the llama rules, at several mesh shapes;
- `shard_params` on 2 and 4 gloo ranks (tests/torch_dist.py): every local
  block has the shape of JAX's `NamedSharding.shard_shape` for the leaf,
  `gather_params` gives the tree back bit for bit, a sharded embedding's
  lookup equals the table's rows, and each axis' group has its size.
Exact: these are shapes, specs and copies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vitron_tpu.core import mesh as jm
from vitron_tpu.kernels.quantization import quantize_llama
from vitron_tpu.models import vitron_model as jvm
from vitron_tpu.models.llm import llama as jl
from vitron_tpu_torch.core import mesh as tm
from vitron_tpu_torch.models import vitron_model as tvm
from vitron_tpu_torch.models.llm import llama as tl

import torch_dist
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SHAPES = [None, {"fsdp": -1}, {"fsdp": 2, "tensor": 2, "data": 2}, {"tensor": 2, "fsdp": -1},
          {"context": 8}, {"data": 4, "tensor": 2}]


@pytest.fixture(scope="module")
def trees():
    cfg = jvm.VitronConfig.tiny()
    params = jax.tree.map(np.asarray, jvm.init_params(jax.random.PRNGKey(0), cfg))
    q = dict(params)
    q["llm"] = jax.tree.map(np.asarray, quantize_llama(jax.tree.map(jnp.asarray, params["llm"]),
                                                       bits=4, head=True))
    return {"f32": params, "int4": q}


@pytest.mark.parametrize("shape", SHAPES)
def test_create_mesh_shapes(shape):
    want = jm.create_mesh(shape)
    assert tm.mesh_sizes(shape, 8) == tuple(want.devices.shape)
    assert tm.MESH_AXES == tuple(want.axis_names)


@pytest.mark.parametrize("shape", [{"tensor": 3, "fsdp": -1}, {"fsdp": 4}, {"fsdp": 2, "data": 2}])
def test_create_mesh_errors(shape):
    with pytest.raises(ValueError) as want:
        jm.create_mesh(shape)
    with pytest.raises(ValueError) as got:
        tm.mesh_sizes(shape, 8)
    assert str(got.value) == str(want.value)
    with pytest.raises(RuntimeError, match="process group"):
        tm.create_mesh(shape)  # no group in this process


def _jax_specs(tree, mesh, rules):
    shardings = jm.make_param_shardings(tree, mesh, rules)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {tuple(jm._key_str(k) for k in kp): tuple(s.spec) for kp, s in flat}


@pytest.mark.parametrize("tree", ["f32", "int4"])
@pytest.mark.parametrize("shape", [{"fsdp": -1}, {"fsdp": 2, "tensor": 2, "data": 2},
                                   {"tensor": 2, "fsdp": -1}, {"data": 4, "tensor": 2}])
def test_specs_match_jax_on_every_leaf(trees, tree, shape):
    params = trees[tree]
    jmesh = jm.create_mesh(shape)
    sizes = dict(zip(jmesh.axis_names, jmesh.devices.shape))
    for rules_j, rules_t, sub in ((jvm.VITRON_SHARDING_RULES, tvm.VITRON_SHARDING_RULES, None),
                                  (jl.LLAMA_SHARDING_RULES, tl.LLAMA_SHARDING_RULES, "llm")):
        t = params if sub is None else params[sub]
        want = _jax_specs(t, jmesh, rules_j)
        got = {p: tm.fit_spec(tm.spec_for(p, rules_t), tuple(leaf.shape), sizes)
               for p, leaf in tm.tree_paths(t)}
        assert got == want
    assert any("tensor" in s for s in got.values())


@pytest.mark.parametrize("n", [2, 4])
def test_shards_on_gloo_ranks(trees, tmp_path, n):
    shape = {"tensor": 2, "fsdp": -1}
    params = trees["int4"]
    outs = torch_dist.run(n, "torch_mesh_bodies:mesh_checks", params, shape, tmp=tmp_path)
    jmesh = jm.create_mesh({"tensor": 2, "fsdp": n // 2}, devices=jax.devices()[:n])
    shardings = jm.make_param_shardings(params, jmesh, jvm.VITRON_SHARDING_RULES)
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    leaves = dict(tm.tree_paths(params))
    want = {"/".join(jm._key_str(k) for k in kp):
            (tuple(s.shard_shape(leaves[tuple(jm._key_str(k) for k in kp)].shape)), tuple(s.spec))
            for kp, s in flat}
    for rank, out in enumerate(outs):
        assert out["shape"] == {"data": 1, "fsdp": n // 2, "tensor": 2, "context": 1}
        assert out["size"] == n
        assert out["groups"]["tensor"] == (2, rank % 2)
        assert out["groups"]["fsdp"] == (n // 2, rank // 2)
        assert out["exact"] and out["lookup"]
        assert out["local_mesh"] == {"data": 1, "fsdp": n, "tensor": 1, "context": 1}
        assert out["local"] == want
    wo = outs[0]["local"]["llm/layers/wo/q4"]  # a row split cuts whole packed rows
    assert wo == ((2, 16, 64 // (n // 2)), (None, "tensor", "fsdp"))
    assert outs[0]["local"]["llm/layers/wo/s"][1] == (None, None, "fsdp")
