"""The multimodal training step and its optimizer, in PyTorch.

Port of `vitron_tpu/train/train_step.py` (which replaced the reference's
DeepSpeed ZeRO-2 + HF Trainer stack, reference: vitron/train/train.py:
1029-1264). optax's transformations become `Optimizer`: `torch.optim.AdamW`
under the formulas of `optax.chain(clip_by_global_norm(c), adamw(lr))`, with
the learning rate of each step taken from a schedule of optax's step count
(the first update uses count 0). AdamW's update is optax's
(m_hat / (sqrt(v_hat) + eps) + wd p) x lr; the clip is optax's, t when the
global norm is below c and t / norm * c otherwise (not `clip_grad_norm_`,
which adds 1e-6).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from vitron_tpu_torch.models import vitron_model
from vitron_tpu_torch.train.losses import causal_lm_loss

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


def named_leaves(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...],
                                                                             torch.Tensor]]:
    """(key path, tensor) for every leaf of nested dicts, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> float:
    """optax.clip_by_global_norm in place; -> the norm before clipping
    (summed in float32)."""
    norm = math.sqrt(sum(float(g.to(torch.float32).square().sum()) for g in grads))
    if norm >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm


class Optimizer:
    """Per group of tensors: clip_by_global_norm(grad_clip) over the group,
    then AdamW at the group's scheduled learning rate (optax.multi_transform
    of one chain per group). A tensor with no gradient steps with zeros, as
    in JAX, where every trainable leaf has one."""

    def __init__(self, groups: Sequence[Tuple[Sequence[torch.Tensor], Schedule]],
                 grad_clip: Optional[float] = 1.0, weight_decay: float = 0.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.schedules = [sched for _, sched in groups]
        self.inner = torch.optim.AdamW([{"params": list(ps), "lr": 0.0} for ps, _ in groups],
                                       lr=0.0, betas=(b1, b2), eps=eps,
                                       weight_decay=weight_decay)
        self.grad_clip = grad_clip
        self.count = 0

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for group, sched in zip(self.inner.param_groups, self.schedules):
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if self.grad_clip:
                clip_by_global_norm_([p.grad for p in group["params"]], self.grad_clip)
            group["lr"] = sched(self.count)
        self.inner.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.inner.load_state_dict(state["inner"])
        self.count = int(state["count"])


def make_optimizer(params: Sequence[torch.Tensor], lr: float = 2e-4, weight_decay: float = 0.0,
                   b1: float = 0.9, b2: float = 0.999,
                   grad_clip: Optional[float] = 1.0) -> Optimizer:
    """AdamW of the reference finetune recipe (finetune_lora.sh:27-33) over
    `params`, at a constant learning rate."""
    return Optimizer([(params, constant_schedule(lr))], grad_clip=grad_clip,
                     weight_decay=weight_decay, b1=b1, b2=b2)


def forward_loss(params: Dict[str, Any], cfg: vitron_model.VitronConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The multimodal forward on a training batch -> the causal-LM loss."""
    logits, _ = vitron_model.forward(
        params, cfg, batch["token_ids"], batch["media_idx"], batch["use_media"],
        batch["positions"], batch["attn_mask"], images=batch.get("images"),
        videos=batch.get("videos"), block_perm=batch.get("block_perm"),
        region_boxes=batch.get("region_boxes"), region_block_idx=batch.get("region_block_idx"))
    return causal_lm_loss(logits, batch["labels"])


def _mask_grads(params: Dict[str, Any], trainable_filter) -> None:
    """Zero the gradients of the leaves the filter freezes."""
    for path, p in named_leaves(params):
        if p.grad is not None and not trainable_filter(path):
            p.grad.zero_()


def make_train_step(cfg: vitron_model.VitronConfig, optimizer: Optimizer,
                    trainable_filter=None):
    """-> step(params, batch) -> loss: one optimizer step over the tensors
    the optimizer holds. batch: the plan tensors, labels and optional media.
    With `trainable_filter(path) -> bool`, frozen leaves get zero gradients
    (the reference freezes the towers, train.py:1185-1212)."""

    def step(params: Dict[str, Any], batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        optimizer.zero_grad()
        loss = forward_loss(params, cfg, batch)
        loss.backward()
        if trainable_filter is not None:
            _mask_grads(params, trainable_filter)
        optimizer.step()
        return loss.detach()

    return step


def leaves(tree: Any) -> List[torch.Tensor]:
    return [t for _, t in named_leaves(tree)]
