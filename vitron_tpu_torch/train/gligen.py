"""GLIGEN grounded fine-tuning: the gated self-attention fusers and the
PositionNet (and the grounding downsamplers) train, the SD backbone stays
frozen.

Port of `vitron_tpu/train/gligen.py` (the reference GLIGEN trainer,
reference: modules/GLIGEN/trainer.py:218-245 the trainable selection,
:353-372 run_one_step's eps-MSE, openaimodel.py:426-429 the 10% grounding
drop, main.py:26-27 AdamW lr 5e-5, wd 0). The frozen/trainable split is
`requires_grad`: frozen tensors take no gradient and no optimizer state,
and gradients still flow through them to the fusers, as optax's
`set_to_zero` branch does in JAX. A step's random draws (the whole-batch
grounding drop, t, the noise) come in as tensors, so a test can hand over
JAX's own draws, or from a `torch.Generator` (`draw`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from vitron_tpu_torch.models.diffusion import unet2d
from vitron_tpu_torch.models.diffusion.losses import diffusion_loss
from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule
from vitron_tpu_torch.train import train_step as ts


@dataclasses.dataclass(frozen=True)
class GligenTrainConfig:
    """Defaults follow modules/GLIGEN/main.py:26-35."""
    lr: float = 5e-5
    weight_decay: float = 0.0
    p_drop_grounding: float = 0.1     # openaimodel.py:428 whole-null drop
    l_simple_weight: float = 1.0
    input_conv_train: bool = False    # the inpainting variant trains conv_in
    grad_clip_norm: Optional[float] = None


def _is_trainable(path, input_conv_train: bool) -> bool:
    keys = list(path)
    if "fuser" in keys or "position_net" in keys or "downsample_net" in keys:
        return True
    # the inpainting UNet's widened first conv lives at
    # params["input_blocks"][0][0]{w,b} (trainer.py:232-236)
    return input_conv_train and keys[:3] == ["input_blocks", 0, 0]


def trainable_mask(params: Dict[str, Any], cfg: GligenTrainConfig) -> Dict[str, Any]:
    """Bools in the params' structure: True on the leaves the reference
    trainer optimises."""
    return ts.map_leaves(lambda path, _: _is_trainable(path, cfg.input_conv_train), params)


def trainable_leaves(params: Dict[str, Any], cfg: GligenTrainConfig):
    """[(key path, tensor)] of the trainable leaves, in tree order."""
    return [(path, p) for path, p in ts.named_leaves(params)
            if _is_trainable(path, cfg.input_conv_train)]


def partition_params(params: Dict[str, Any], cfg: GligenTrainConfig):
    """(trainable, frozen) element counts (reference count_params, trainer.py:114)."""
    n_train = n_frozen = 0
    for path, p in ts.named_leaves(params):
        if _is_trainable(path, cfg.input_conv_train):
            n_train += p.numel()
        else:
            n_frozen += p.numel()
    return n_train, n_frozen


def make_optimizer(cfg: GligenTrainConfig) -> ts.Transform:
    """clip_by_global_norm (when set), then AdamW at cfg.lr, over the
    trainable tensors."""
    txs = [ts.clip_by_global_norm(cfg.grad_clip_norm)] if cfg.grad_clip_norm is not None else []
    return ts.chain(*txs, ts.adamw(cfg.lr, weight_decay=cfg.weight_decay))


def draw(gen: torch.Generator, x0: torch.Tensor, sched: DiffusionSchedule,
         cfg: GligenTrainConfig) -> Dict[str, torch.Tensor]:
    """A step's draws from `gen`: the whole-batch grounding drop (one
    uniform < p_drop_grounding, gligen.py:111-112), t ~ randint(0, T) a row
    and the noise."""
    dev = x0.device
    return {"drop": torch.rand((), generator=gen, device=dev) < cfg.p_drop_grounding,
            "t": torch.randint(0, sched.num_timesteps, (x0.shape[0],), generator=gen, device=dev),
            "noise": torch.randn(x0.shape, generator=gen, device=dev, dtype=x0.dtype)}


def make_gligen_loss(unet_cfg: unet2d.UNetConfig, sched: DiffusionSchedule,
                     tcfg: GligenTrainConfig):
    """-> loss_fn(params, batch, draws): the grounding tokens recomputed from
    the (dropped or kept) boxes, then the eps-MSE of the UNet at x_t."""

    def loss_fn(params, batch, draws):
        x0 = batch["x0"]
        # the drop zeroes boxes, masks and embeddings, as get_null_input does
        # (text_grounding_tokinzer_input.py:29-44)
        zero = torch.where(torch.as_tensor(draws["drop"], device=x0.device), 0.0, 1.0)
        objs = unet2d.grounding_tokens(params, batch["boxes"] * zero, batch["masks"] * zero,
                                       batch["phrase_emb"] * zero)

        def model_fn(xt, t):
            return unet2d.forward(params, unet_cfg, xt.to(x0.dtype), t, batch["context"],
                                  objs=objs)

        per = diffusion_loss(model_fn, x0, draws["t"], draws["noise"], sched,
                             mean_type="eps", loss_type="mse")
        return per.mean() * tcfg.l_simple_weight

    return loss_fn


def make_gligen_train_step(unet_cfg: unet2d.UNetConfig, sched: DiffusionSchedule,
                           tcfg: GligenTrainConfig, optimizer: Optional[ts.Transform] = None):
    """-> (step, init_state).

    init_state(params) -> state {"params", "opt_state"}: the trainable leaves
    require grad and take the optimizer's state, the frozen ones neither.
    step(state, batch, draws, grads=None) -> (state, loss): one optimizer
    step, in place. batch:
      x0         [B, H, W, 4]          VAE latents (already scaled)
      context    [B, L, 768]           CLIP text embeddings
      boxes      [B, max_box, 4]       normalised xyxy
      masks      [B, max_box]          box validity (float)
      phrase_emb [B, max_box, 768]     CLIP phrase embeddings
    draws: {"drop", "t", "noise"} or a torch.Generator (`draw`). `grads`, a
    dict, receives a copy of each trainable gradient under its key path
    before the optimizer uses it up. `optimizer` is a transform over the
    trainable tensors (default `make_optimizer(tcfg)`).
    """
    loss_fn = make_gligen_loss(unet_cfg, sched, tcfg)
    tx = optimizer or make_optimizer(tcfg)

    def trained(params):
        return [p for _, p in trainable_leaves(params, tcfg)]

    def init_state(params):
        for path, p in ts.named_leaves(params):
            p.requires_grad_(_is_trainable(path, tcfg.input_conv_train))
        return {"params": params, "opt_state": tx.init(trained(params))}

    def step(state, batch, draws: Union[Dict[str, torch.Tensor], torch.Generator], grads=None):
        params = state["params"]
        if isinstance(draws, torch.Generator):
            draws = draw(draws, batch["x0"], sched, tcfg)
        leaves = trained(params)
        ts.zero_grad(leaves)
        with torch.enable_grad():
            loss = loss_fn(params, batch, draws)
            loss.backward()
        ts.copy_grads(params, grads)
        opt_state = ts.apply_gradients(tx, leaves, state["opt_state"])
        return {"params": params, "opt_state": opt_state}, loss.detach()

    return step, init_state
