"""Device mesh and sharding helpers.

Port of `vitron_tpu/core/mesh.py`. The JAX package names four mesh axes

    data    — batch (replaces DDP/ZeRO data parallel)
    fsdp    — parameter sharding at rest (replaces ZeRO-3)
    tensor  — megatron-style tensor parallel within attention/MLP
    context — sequence/ring parallel for long-context attention

and places parameters by per-model rule tables of PartitionSpecs, leaving
XLA to insert the collectives. Here one process runs per device
(`core/distributed.py`), a `Mesh` is `torch.distributed.device_mesh.
init_device_mesh` over the world with the same axis names, and a sharded
parameter is a `Shard`: this rank's block of the full tensor with the spec
that cut it. The collectives are written out where the block is used
(`distributed/tensor_parallel.py`, the llama forward).

The collectives carry gradients (the sharded train step,
`train/train_step.py`), each an `autograd.Function` taken only where its
input requires a gradient, so a serving call runs the plain collective. The
batch is split on `data` only, so every rank of an fsdp or tensor group
sees the same rows and what follows a gather runs the same on each of them:
the gradient of an all-gather is this rank's slice of the incoming one (a
reduce-scatter would count it once a rank), and the gradient of an
all-reduce (Megatron's "g") is the incoming one.

A spec is a tuple with one entry a dim: None (replicated) or an axis name.
`spec_for` and `fit_spec` are the JAX package's functions on paths and
shapes; `fit_spec` replicates a dim whose axis size does not divide it, so
one rule covers a weight and its satellites (quantization scales, packed
int4 rows: a row split of {"q4", "s"} cuts whole packed rows and the [1, N]
scale replicates).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
CONTEXT_AXIS = "context"

MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, CONTEXT_AXIS)

Spec = Tuple[Any, ...]


def mesh_sizes(shape: Optional[Mapping[str, int]], n: int,
               axes: Sequence[str] = MESH_AXES) -> Tuple[int, ...]:
    """The axis sizes of a mesh of `n` devices, as JAX's `create_mesh`
    reads `shape`: missing axes get 1, one axis may be -1 to take the rest
    (default: everything on `fsdp`)."""
    shape = dict(shape or {FSDP_AXIS: -1})
    sizes, wildcard = [], None
    for ax in axes:
        s = shape.get(ax, 1)
        if s == -1:
            wildcard = ax
            sizes.append(1)
        else:
            sizes.append(s)
    fixed = math.prod(sizes)
    if wildcard is not None:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {fixed}")
        sizes[list(axes).index(wildcard)] = n // fixed
    elif fixed != n:
        raise ValueError(f"mesh shape {shape} needs {fixed} devices, have {n}")
    return tuple(sizes)


class Mesh:
    """A device mesh over every rank of the process group: one rank a
    device, ranks laid out row-major over `axis_names`. `shape` maps axis
    -> size (JAX's `mesh.shape`), `group(axis)` is the process group of
    this rank's slice along an axis and `index(axis)` its place in it."""

    def __init__(self, axis_names: Sequence[str], sizes: Sequence[int]):
        from torch.distributed.device_mesh import init_device_mesh

        if not dist.is_initialized():
            raise RuntimeError("a mesh needs a process group: call "
                               "core.distributed.initialize() first")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in sizes)))
        self.device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(self.device_type, tuple(self.shape.values()),
                                            mesh_dim_names=self.axis_names)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        return self.device_mesh.get_local_rank(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def create_mesh(shape: Optional[Mapping[str, int]] = None) -> Mesh:
    """The global mesh over every rank (`mesh_sizes` reads `shape`)."""
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a process group: call "
                           "core.distributed.initialize() first")
    return Mesh(MESH_AXES, mesh_sizes(shape, dist.get_world_size()))


def local_mesh(n: int = 1) -> Mesh:
    """A mesh of n ranks on `fsdp` (the single-device default)."""
    return create_mesh({FSDP_AXIS: n})


def spec_for(path: Tuple[str, ...], rules: Sequence[Tuple[str, Spec]]) -> Spec:
    """First-match sharding rule lookup: a rule's key is a substring of the
    '/'-joined param path."""
    joined = "/".join(str(p) for p in path)
    for key, spec in rules:
        if key in joined:
            return tuple(spec)
    return ()


def _axis_size(mesh, names) -> int:
    sizes = mesh.shape if isinstance(mesh, Mesh) else mesh
    group = names if isinstance(names, tuple) else (names,)
    return math.prod(sizes[a] for a in group)


def fit_spec(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop spec entries that cannot apply to `shape`: axes whose mesh size
    does not divide the dim, and entries beyond the tensor's rank. `mesh`
    is a Mesh or a mapping axis -> size."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, names in zip(shape, parts[: len(shape)]):
        if names is None:
            out.append(None)
            continue
        k = _axis_size(mesh, names)
        out.append(names if k and dim % k == 0 else None)
    return tuple(out)


# ------------------------------------------------------------- collectives


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    t = t.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
        if dim == 0:
            return out
        out = out.reshape((n,) + tuple(t.shape))
    else:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        if dim == 0:
            return torch.cat(parts, dim=0)
        out = torch.stack(parts)
    shape = tuple(t.shape)
    return out.movedim(0, dim).reshape(shape[:dim] + (n * shape[dim],) + shape[dim + 1:])


class _AllGather(torch.autograd.Function):
    """all-gather; backward: this rank's slice of the incoming gradient."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, t.shape[dim]
        return _all_gather(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        start = dist.get_rank(ctx.group) * ctx.size
        return g.narrow(ctx.dim, start, ctx.size), None, None


class _AllReduce(torch.autograd.Function):
    """Megatron's "g": all-reduce (sum), out of place; backward: the identity."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _differentiable(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's `t` of `group` along `dim` (rank order)."""
    if _differentiable(t):
        return _AllGather.apply(t, group, dim)
    return _all_gather(t, group, dim)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum `t` over `group` -> the sum: `t` itself, summed in place, unless
    `t` requires a gradient (then a new tensor, the gradient passed as it
    is)."""
    if _differentiable(t):
        return _AllReduce.apply(t, group)
    dist.all_reduce(t, group=group)
    return t


@dataclasses.dataclass
class Shard:
    """This rank's block of a sharded tensor: `local`, cut from the full
    tensor of `shape` by `spec` (one entry a dim, None or an axis name) on
    `mesh`. Indexing with an int selects along an unsharded dim 0 (the
    stacked layer axis); indexing with an int tensor is an embedding lookup
    of the full tensor's rows, made with the mesh's collectives."""

    local: torch.Tensor
    spec: Spec
    shape: Tuple[int, ...]
    mesh: Mesh

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.local.element_size()

    def __getitem__(self, idx):
        if isinstance(idx, int):
            if self.spec and self.spec[0] is not None:
                raise IndexError(f"int index on dim 0 sharded over {self.spec[0]!r}")
            return Shard(self.local[idx], self.spec[1:], self.shape[1:], self.mesh)
        if torch.is_tensor(idx) and not idx.is_floating_point() and idx.dtype != torch.bool:
            return lookup(self, idx)
        raise TypeError(f"Shard index {type(idx).__name__} is not an int or an int tensor")

    def gather(self, keep: Sequence[str] = ()) -> torch.Tensor:
        """All-gather every sharded dim whose axis is not in `keep`: the full
        tensor for keep=(), this rank's block along the kept axes otherwise."""
        out = self.local
        for d, ax in enumerate(self.spec):
            if ax is not None and ax not in keep:
                out = all_gather(out, self.mesh.group(ax), dim=d)
        return out

    def full(self) -> torch.Tensor:
        return self.gather(())


def lookup(table: Shard, ids: torch.Tensor) -> torch.Tensor:
    """Rows `ids` of a sharded table [V, ...]: with V split over an axis,
    each rank takes the ids in its range (zeros elsewhere), the other dims
    are gathered and the rows summed over that axis (one rank holds each)."""
    ax = table.spec[0] if table.spec else None
    if ax is None:
        rows = table.local[ids]
    else:
        n = table.local.shape[0]
        rel = ids - table.mesh.index(ax) * n
        ok = (rel >= 0) & (rel < n)
        rows = table.local[rel.clamp(0, n - 1)]
        rows = torch.where(ok.reshape(ok.shape + (1,) * (rows.dim() - ok.dim())), rows,
                           torch.zeros((), dtype=rows.dtype, device=rows.device))
    lead = ids.dim() - 1
    for d, a in enumerate(table.spec[1:], start=1):
        if a is not None:
            rows = all_gather(rows, table.mesh.group(a), dim=lead + d)
    if ax is not None:
        rows = all_reduce(rows, table.mesh.group(ax))
    return rows


# ------------------------------------------------------------- param trees


def tree_paths(tree, path: Tuple[str, ...] = ()):
    """(path, leaf) over nested dicts / lists / tuples, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, path + (str(i),))
    else:
        yield path, tree


def tree_map_with_path(fn, tree, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _is_array(leaf) -> bool:
    return torch.is_tensor(leaf) or isinstance(leaf, Shard)


def make_param_shardings(params, mesh, rules: Sequence[Tuple[str, Spec]]):
    """The spec tree of a param tree (None at leaves that are no tensor)."""
    return tree_map_with_path(
        lambda p, leaf: (fit_spec(spec_for(p, rules), tuple(leaf.shape), mesh)
                         if _is_array(leaf) else None), params)


def shard_tensor(t: torch.Tensor, spec: Spec, mesh: Mesh) -> Shard:
    """This rank's block of the full tensor `t` (a copy where a dim is cut,
    so the full tensor can be freed)."""
    local = t
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        if isinstance(ax, tuple):
            raise NotImplementedError(f"dim {d} split over several axes {ax}")
        n = mesh.shape[ax]
        if n > 1:
            size = t.shape[d] // n
            local = local.narrow(d, mesh.index(ax) * size, size)
    if local is not t:
        local = local.clone()
    return Shard(local, tuple(spec), tuple(t.shape), mesh)


def shard_params(params, mesh: Mesh, rules: Sequence[Tuple[str, Spec]]):
    """A full param tree -> this rank's `Shard` tree by the rules."""
    def place(path, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        return shard_tensor(leaf, fit_spec(spec_for(path, rules), tuple(leaf.shape), mesh), mesh)

    return tree_map_with_path(place, params)


def gather_params(tree):
    """A `Shard` tree -> the full tensors (every rank gets them all)."""
    return tree_map_with_path(lambda _, leaf: leaf.full() if isinstance(leaf, Shard) else leaf,
                              tree)

