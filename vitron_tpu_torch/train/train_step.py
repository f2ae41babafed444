"""The multimodal training step and the optimizers, in PyTorch.

Port of `vitron_tpu/train/train_step.py` (which replaced the reference's
DeepSpeed ZeRO-2 + HF Trainer stack, reference: vitron/train/train.py:
1029-1264), and of the optax transformations the JAX trainers chain. Each
`Transform` is an optax `GradientTransformation` over a list of tensors
(init(params) -> state, update(updates, state, params) -> (updates,
state)), written from optax's own formulas and composed as the JAX
trainers compose theirs:
- `clip` (value clip), `clip_by_global_norm` (t when the global norm is
  below c, else t / norm * c: not `clip_grad_norm_`, which adds 1e-6);
- `adamw`: `scale_by_adam` (m_hat / (sqrt(v_hat) + eps)), the decayed
  weights, then the learning rate of a schedule read from optax's count
  (the first update uses count 0);
- `adafactor` at `optax.adafactor`'s defaults (optax/_src/factorized.py):
  second moments factored where the two largest dims are both >= 128
  (not necessarily the last two), decay 1 - (count + 1)^-0.8, eps 1e-30
  added to g^2, then `clip_by_block_rms(1.0)`, the learning rate,
  `scale_by_param_block_rms` (min 1e-3) and the sign
  (`torch.optim.Adafactor` computes another update).
`Optimizer` runs one chain per group of tensors (optax.multi_transform;
frozen tensors are in no group and take no state). An update overwrites the
gradient it came from, tensor by tensor, so a step holds no second copy of
the gradients.

On a mesh (`Shard` leaves, `core/mesh.py`) `make_train_step` runs the
function JAX's GSPMD step runs, with its collectives written out: each rank
takes its `data` slice of the batch's rows (`shard_batch`; the media stay
whole), divides its summed token loss by the count of supervised tokens of
the whole batch, and sums its gradients over `data`; the mesh collectives
carry the rest (a gather's gradient is this rank's slice, Megatron's "f"
and "g" in the llama blocks). The optimizer steps each rank's block
(`Shard.local`), so its moments follow the params' placement, as optax's
on sharded params; `clip_by_global_norm` sums each block's squares over the
axes that cut it.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from vitron_tpu_torch.core.mesh import DATA_AXIS, Shard, all_reduce
from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.train.losses import causal_lm_sums

Schedule = Callable[[int], float]


def constant_schedule(value: float) -> Schedule:
    return lambda count: value


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear from init to peak over
    `warmup_steps`, then cosine decay to `end_value` over the remaining
    `decay_steps - warmup_steps`."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def sched(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cos_steps)) + alpha)

    return sched


def named_leaves(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """(key path, tensor) for every leaf of nested dicts and lists, in
    insertion order: dict keys as strings, list indices as ints."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def map_leaves(fn: Callable[[Tuple, Any], Any], tree: Any, prefix: Tuple = ()) -> Any:
    """fn(key path, leaf) over nested dicts and lists, keeping the
    structure; paths as `named_leaves` names them."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, prefix + (i,)) for i, v in enumerate(tree))
    return fn(prefix, tree)


# ------------------------------------------------------------ transforms


class Transform(NamedTuple):
    """optax.GradientTransformation over a list of tensors. `update` may
    overwrite the update tensors it is given. `factored`: its state is
    shaped by whole tensors (Adafactor's row and column moments), so it
    cannot step a rank's block."""
    init: Callable[[List[torch.Tensor]], Any]
    update: Callable[[List[torch.Tensor], Any, List[torch.Tensor]], Tuple[List[torch.Tensor], Any]]
    factored: bool = False


def _stateless(fn) -> Transform:
    """A transform with no state: fn(update, param) -> update, a tensor at a time."""
    return Transform(lambda params: {},
                     lambda updates, state, params: ([fn(u, p) for u, p in zip(updates, params)],
                                                     state))


def _counted(fn) -> Transform:
    """A transform whose state is optax's step count: fn(update, param,
    count) -> update; the first update sees count 0."""
    def update(updates, state, params):
        count = state["count"]
        return [fn(u, p, count) for u, p in zip(updates, params)], {"count": count + 1}

    return Transform(lambda params: {"count": 0}, update)


def chain(*transforms: Transform) -> Transform:
    """optax.chain."""
    def init(params):
        return [t.init(params) for t in transforms]

    def update(updates, state, params):
        new = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, new

    return Transform(init, update, any(t.factored for t in transforms))


def clip(max_delta: float) -> Transform:
    """optax.clip: each element into [-max_delta, max_delta]."""
    return _stateless(lambda u, p: u.clamp_(-max_delta, max_delta))


Cuts = Optional[Sequence[Tuple[str, ...]]]


def global_norm(tensors: Sequence[torch.Tensor], cuts: Cuts = None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every element's square, summed in float32 a tensor
    at a time (optax.global_norm); a 0-dim tensor on the tensors' device.
    With `cuts` (per tensor, the mesh axes that cut it, or () for a whole
    one) each tensor is a rank's block: its sum of squares is all-reduced
    over those axes, and only those, so a replicated tensor counts once. The
    sums are bucketed by their axes (one all-reduce an axis a bucket, in
    the same order on every rank), then added tensor by tensor in order, as
    without a mesh."""
    sums = [t.to(torch.float32).square().sum() for t in tensors]
    if cuts is not None:
        buckets: Dict[Tuple[str, ...], List[int]] = {}
        for i, axes in enumerate(cuts):
            if axes:
                buckets.setdefault(tuple(axes), []).append(i)
        for axes in sorted(buckets):
            idx = buckets[axes]
            summed = torch.stack([sums[i] for i in idx])
            for ax in axes:
                summed = all_reduce(summed, mesh.group(ax))
            for j, i in enumerate(idx):
                sums[i] = summed[j]
    return torch.sqrt(sum(sums))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float, cuts: Cuts = None,
                         mesh=None) -> torch.Tensor:
    """optax.clip_by_global_norm in place: t if the global norm is below
    max_norm, else t / norm * max_norm (the norm over a mesh with `cuts`,
    as `global_norm`). -> the norm before clipping."""
    norm = global_norm(grads, cuts, mesh)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


def clip_by_global_norm(max_norm: float, cuts: Cuts = None, mesh=None) -> Transform:
    """optax.clip_by_global_norm over the transform's tensors (rank blocks
    cut by `cuts` on `mesh`, as `global_norm`). Its state keeps the last
    norm before clipping."""
    def update(updates, state, params):
        return updates, {"norm": clip_by_global_norm_(updates, max_norm, cuts, mesh)}

    return Transform(lambda params: {}, update)


def scale(factor: float) -> Transform:
    return _stateless(lambda u, p: u.mul_(factor))


def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    return lr if callable(lr) else constant_schedule(lr)


def scale_by_learning_rate(lr: Union[float, Schedule], flip_sign: bool = True) -> Transform:
    """optax.scale_by_learning_rate: u * (-)lr(count), the count from 0."""
    sched, sign = _as_schedule(lr), -1.0 if flip_sign else 1.0
    return _counted(lambda u, p, count: u.mul_(sign * float(sched(count))))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    """optax.scale_by_adam: mu and nu moments, bias-corrected at the
    incremented count, m_hat / (sqrt(v_hat) + eps)."""
    def init(params):
        return {"count": 0, "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def update(updates, state, params):
        count = state["count"] + 1
        # optax's 1 - decay^count, in float32
        c1, c2 = (float(np.float32(1.0) - np.float32(b) ** np.float32(count)) for b in (b1, b2))
        for u, m, v in zip(updates, state["mu"], state["nu"]):
            m.mul_(b1).add_(u, alpha=1.0 - b1)
            v.mul_(b2).addcmul_(u, u, value=1.0 - b2)
            torch.div(m / c1, torch.sqrt(v / c2) + eps, out=u)
        return updates, {**state, "count": count}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    """optax.add_decayed_weights: u + wd * p."""
    return _stateless(lambda u, p: u.add_(p, alpha=weight_decay))


def adamw(lr: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Transform:
    """optax.adamw (its default weight decay 1e-4)."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(lr))


# optax.adafactor's defaults
_FACTOR_MIN_DIM = 128  # min_dim_size_to_factor
_DECAY_RATE = 0.8
_EPS = 1e-30
_PARAM_SCALE_MIN = 1e-3  # scale_by_param_block_rms's min_scale


def _factored_dims(shape):
    """optax's: the two largest axes (second largest, largest) when both
    reach _FACTOR_MIN_DIM, else None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < _FACTOR_MIN_DIM:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def scale_by_factored_rms() -> Transform:
    """optax.scale_by_factored_rms at its defaults (Adafactor's second
    moments): a row and a column mean of g^2 + _EPS over the two largest
    axes d1 < d0 in size order, or a full one where the tensor does not
    factor, decayed by 1 - (count + 1)^-_DECAY_RATE in float32."""
    def init(params):
        state = {"count": 0, "v_row": [], "v_col": [], "v": []}
        for p in params:
            dims = _factored_dims(tuple(p.shape))
            one = torch.zeros((1,), dtype=p.dtype, device=p.device)
            if dims is None:
                state["v_row"].append(one)
                state["v_col"].append(one.clone())
                state["v"].append(torch.zeros_like(p))
            else:
                d1, d0 = dims
                state["v_row"].append(torch.zeros([n for i, n in enumerate(p.shape) if i != d0],
                                                  dtype=p.dtype, device=p.device))
                state["v_col"].append(torch.zeros([n for i, n in enumerate(p.shape) if i != d1],
                                                  dtype=p.dtype, device=p.device))
                state["v"].append(one)
        return state

    def update(updates, state, params):
        count = state["count"]
        decay = float(np.float32(1.0) - np.float32(count + 1) ** np.float32(-_DECAY_RATE))
        for i, (u, p) in enumerate(zip(updates, params)):
            g_sq = u * u + _EPS
            dims = _factored_dims(tuple(p.shape))
            if dims is None:
                v = state["v"][i].mul_(decay).add_(g_sq, alpha=1.0 - decay)
                u.mul_(v.rsqrt())
                continue
            d1, d0 = dims
            v_row = state["v_row"][i].mul_(decay).add_(g_sq.mean(d0), alpha=1.0 - decay)
            v_col = state["v_col"][i].mul_(decay).add_(g_sq.mean(d1), alpha=1.0 - decay)
            del g_sq
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)).rsqrt()
            u.mul_(row_factor.unsqueeze(d0)).mul_(v_col.rsqrt().unsqueeze(d1))
        return updates, {**state, "count": count + 1}

    return Transform(init, update, factored=True)


def clip_by_block_rms(threshold: float) -> Transform:
    """optax.clip_by_block_rms: u / max(1, rms(u) / threshold), a tensor at
    a time."""
    return _stateless(lambda u, p: u.div_(torch.clamp(
        torch.sqrt(u.square().mean()) / threshold, min=1.0)))


def scale_by_param_block_rms() -> Transform:
    """optax.scale_by_param_block_rms at its default: u * max-like(rms(p),
    _PARAM_SCALE_MIN) (rms at or below it gives _PARAM_SCALE_MIN)."""
    def fn(u, p):
        rms = torch.sqrt(p.square().mean())
        return u.mul_(torch.where(rms <= _PARAM_SCALE_MIN,
                                  torch.full_like(rms, _PARAM_SCALE_MIN), rms))

    return _stateless(fn)


def adafactor(lr: Union[float, Schedule]) -> Transform:
    """optax.adafactor(lr) at its defaults (min_dim_size_to_factor 128,
    decay_rate 0.8, multiply_by_parameter_scale, clipping_threshold 1.0,
    no momentum, no weight decay, eps 1e-30)."""
    return chain(scale_by_factored_rms(), clip_by_block_rms(1.0),
                 scale_by_learning_rate(lr, flip_sign=False), scale_by_param_block_rms(),
                 scale(-1.0))


@torch.no_grad()
def apply_gradients(tx: Transform, params: Sequence[torch.Tensor], state: Any) -> Any:
    """One step of `tx` over `params` from their `.grad` (optax's update,
    then apply_updates): each gradient becomes its update in place, is added
    and dropped. A tensor with no gradient steps with zeros, as in JAX,
    where every trainable leaf has one. -> the new state."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    updates, state = tx.update(grads, state, list(params))
    for p, u in zip(params, updates):
        p.add_(u)
        p.grad = None
    return state


def _local(leaf):
    return leaf.local if isinstance(leaf, Shard) else leaf


def copy_grads(params: Any, grads: Optional[dict]) -> None:
    """Into `grads` (when given): a copy of each gradient of the tree under
    its key path (of a `Shard`, its block's)."""
    if grads is not None:
        grads.update({path: _local(p).grad.detach().clone() for path, p in named_leaves(params)
                      if _local(p).grad is not None})


def zero_grad(params: Sequence[torch.Tensor]) -> None:
    for p in params:
        p.grad = None


def _placement(params: Sequence[Any]):
    """(the mesh axes that cut each leaf, the mesh) of a list of tensors and
    `Shard`s -> (None, None) where none is a Shard."""
    meshes = [p.mesh for p in params if isinstance(p, Shard)]
    if not meshes:
        return None, None
    cuts = [tuple(sorted({ax for ax in p.spec if ax is not None}))
            if isinstance(p, Shard) else () for p in params]
    return cuts, meshes[0]


class Optimizer:
    """One transform chain per group of tensors (optax.multi_transform),
    stepped by `apply_gradients`. A group may hold `Shard`s: the chain
    steps their blocks (`local`); a factored transform refuses them."""

    def __init__(self, groups: Sequence[Tuple[Sequence[Any], Transform]]):
        self.groups = []
        for ps, tx in groups:
            ps = list(ps)
            if tx.factored and any(isinstance(p, Shard) for p in ps):
                raise NotImplementedError(
                    "a factored transform (Adafactor's row and column moments) cannot step a "
                    "Shard's block: its moments are means over whole dims")
            self.groups.append(([_local(p) for p in ps], tx))
        self.states = [tx.init(ps) for ps, tx in self.groups]
        self.count = 0

    def tensors(self) -> List[torch.Tensor]:
        return [p for ps, _ in self.groups for p in ps]

    def zero_grad(self) -> None:
        zero_grad(self.tensors())

    def step(self) -> None:
        for i, (ps, tx) in enumerate(self.groups):
            self.states[i] = apply_gradients(tx, ps, self.states[i])
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"states": self.states, "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.states = state["states"]
        self.count = int(state["count"])


def make_optimizer(params: Sequence[Any], lr: float = 2e-4, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999,
                   grad_clip: Optional[float] = 1.0) -> Optimizer:
    """AdamW of the reference finetune recipe (finetune_lora.sh:27-33) over
    `params` (tensors, or `Shard`s: their blocks, with the clip's norm over
    the mesh), at a constant learning rate, after clip_by_global_norm."""
    params = list(params)
    txs = [clip_by_global_norm(grad_clip, *_placement(params))] if grad_clip else []
    return Optimizer([(params, chain(*txs, adamw(lr, b1, b2, weight_decay=weight_decay)))])


def set_trainable(params: Any, trainable_filter=None) -> List[Any]:
    """requires_grad on each floating leaf that `trainable_filter(path)`
    passes (every one without a filter), of a `Shard` on its block, and off
    on the others -> the trainable leaves in tree order (what
    `make_optimizer` takes)."""
    out = []
    for path, leaf in named_leaves(params):
        t = _local(leaf)
        if not torch.is_tensor(t):
            continue
        on = t.is_floating_point() and (trainable_filter is None or trainable_filter(path))
        t.requires_grad_(on)
        if on:
            out.append(leaf)
    return out


# the batch arrays indexed by row, split on `data` (JAX's P("data")); the
# media arrays stay whole on every rank, as JAX leaves them unplaced
ROW_KEYS = ("token_ids", "media_idx", "use_media", "positions", "attn_mask", "labels")


def shard_batch(batch: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """This rank's `data` slice of the batch's row-indexed arrays."""
    n, i = mesh.shape[DATA_AXIS], mesh.index(DATA_AXIS)
    out = dict(batch)
    for k in ROW_KEYS:
        rows = batch[k].shape[0]
        if rows % n:
            raise ValueError(f"a batch of {rows} rows does not split over data={n}")
        out[k] = batch[k].narrow(0, i * (rows // n), rows // n)
    return out


def tree_mesh(params: Any):
    """The mesh of the first `Shard` leaf, or None."""
    for _, leaf in named_leaves(params):
        if isinstance(leaf, Shard):
            return leaf.mesh
    return None


def forward_sums(params: Dict[str, Any], cfg: vitron_model.VitronConfig,
                 batch: Dict[str, torch.Tensor]):
    """The multimodal forward on a training batch -> (the summed token loss,
    the count of supervised tokens)."""
    logits, _ = vitron_model.forward(
        params, cfg, batch["token_ids"], batch["media_idx"], batch["use_media"],
        batch["positions"], batch["attn_mask"], images=batch.get("images"),
        videos=batch.get("videos"), block_perm=batch.get("block_perm"),
        region_boxes=batch.get("region_boxes"), region_block_idx=batch.get("region_block_idx"))
    return causal_lm_sums(logits, batch["labels"])


def forward_loss(params: Dict[str, Any], cfg: vitron_model.VitronConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The multimodal forward on a training batch -> the causal-LM loss."""
    total, count = forward_sums(params, cfg, batch)
    return total / torch.clamp(count, min=1)


def _mask_grads(params: Dict[str, Any], trainable_filter) -> None:
    """Zero the gradients of the leaves the filter freezes."""
    for path, p in named_leaves(params):
        p = _local(p)
        if p.grad is not None and not trainable_filter(path):
            p.grad.zero_()


@torch.no_grad()
def _sum_grads(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor's gradient over `group` (a tensor with none as
    zeros, so that every rank issues the same all-reduces)."""
    for p in tensors:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        all_reduce(p.grad, group)


def make_train_step(cfg: vitron_model.VitronConfig, optimizer: Optimizer,
                    trainable_filter=None):
    """-> step(params, batch, grads=None) -> loss: one optimizer step over
    the tensors the optimizer holds. batch: the plan tensors, labels and
    optional media of the whole batch. With `trainable_filter(path) ->
    bool`, frozen leaves get zero gradients (the reference freezes the
    towers, train.py:1185-1212). Into `grads` (when given) go the gradients
    the optimizer is handed (`copy_grads`).

    Over `Shard` leaves the step runs on their mesh: this rank's `data` rows,
    the loss of the whole batch (the summed token loss over the count of
    supervised tokens all-reduced over `data`), the gradients summed over
    `data` (at any size), and the loss returned all-reduced, so every rank
    returns the whole batch's."""

    def step(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
             grads: Optional[dict] = None) -> torch.Tensor:
        optimizer.zero_grad()
        mesh = tree_mesh(params)
        if mesh is None:
            loss = forward_loss(params, cfg, batch)
            loss.backward()
        else:
            data = mesh.group(DATA_AXIS)
            total, count = forward_sums(params, cfg, shard_batch(batch, mesh))
            loss = total / torch.clamp(all_reduce(count, data), min=1)
            loss.backward()
            _sum_grads(optimizer.tensors(), data)
            loss = all_reduce(loss.detach(), data)
        if trainable_filter is not None:
            _mask_grads(params, trainable_filter)
        copy_grads(params, grads)
        optimizer.step()
        return loss.detach()

    return step


def leaves(tree: Any) -> List[torch.Tensor]:
    return [t for _, t in named_leaves(tree)]
