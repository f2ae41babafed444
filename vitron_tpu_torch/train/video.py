"""Video-diffusion fine-tuning for the UNetSD family (T2V / I2VGen).

Port of `vitron_tpu/train/video.py` (the reference's t2v training entry,
reference: modules/i2vgen-xl/tools/train/train_t2v_enterance.py:123-290):
AdamW at the AnnealingLR warmup/cosine schedule
(utils/optim/lr_scheduler.py:6-43), the v-prediction diffusion loss with the
optional divergence regulariser (diffusion_ddim.py:367-443), classifier-free
text dropout (`p_zero`, :222-226) to the null embedding, gradient value
clipping (`clip_grad_value_(..., 0.05)`, :246), and an EMA of the weights,
`ema = model.lerp(ema, decay)` (:258-262). The whole UNet trains. A step's
draws (the per-row text drop, t, the noise) come in as tensors, so a test
can hand over JAX's own draws, or from a `torch.Generator` (`draw`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from vitron_tpu_torch.models.diffusion import unet_sd_video
from vitron_tpu_torch.models.diffusion.losses import diffusion_loss
from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule
from vitron_tpu_torch.train import train_step as ts


@dataclasses.dataclass(frozen=True)
class VideoTrainConfig:
    """Defaults follow configs/t2v_train.yaml + train_t2v_enterance.py."""
    lr: float = 3e-5
    weight_decay: float = 0.0
    warmup_steps: int = 10
    total_steps: int = 200_000
    decay_mode: str = "cosine"            # 'linear' | 'cosine' | 'none'
    min_lr: float = 0.0
    use_ema: bool = True
    ema_decay: float = 0.9998
    grad_clip_value: Optional[float] = 0.05   # clip_grad_value_ (FSDP branch)
    p_zero: float = 0.1                   # CFG text dropout probability
    mean_type: str = "v"
    loss_type: str = "mse"
    use_div_loss: bool = False


def annealing_lr(cfg: VideoTrainConfig, step: int) -> float:
    """AnnealingLR.get_lr (lr_scheduler.py:19-30) at the scheduler's step, in
    float32 as JAX computes it; step 0 inside the warmup gives 0, as in the
    reference."""
    f32 = np.float32
    step = f32(step)
    warm = f32(cfg.lr) * step / f32(max(cfg.warmup_steps, 1))
    ratio = (step - f32(cfg.warmup_steps)) / f32(max(cfg.total_steps - cfg.warmup_steps, 1))
    ratio = np.clip(ratio, f32(0.0), f32(1.0))
    if cfg.decay_mode == "linear":
        decayed = f32(cfg.lr) * (f32(1.0) - ratio)
    elif cfg.decay_mode == "cosine":
        decayed = f32(cfg.lr) * (np.cos(f32(np.pi) * ratio) + f32(1.0)) / f32(2.0)
    elif cfg.decay_mode == "none":
        decayed = f32(cfg.lr)
    else:
        raise ValueError(cfg.decay_mode)
    lr = warm if cfg.warmup_steps > 0 and step <= cfg.warmup_steps else decayed
    return float(max(f32(lr), f32(cfg.min_lr)))


def make_optimizer(cfg: VideoTrainConfig) -> ts.Transform:
    """The value clip (when set), then AdamW at `annealing_lr`."""
    txs = [ts.clip(cfg.grad_clip_value)] if cfg.grad_clip_value is not None else []
    return ts.chain(*txs, ts.adamw(lambda count: annealing_lr(cfg, count),
                                   weight_decay=cfg.weight_decay))


@torch.no_grad()
def ema_update(ema: Dict[str, Any], params: Dict[str, Any], decay: float) -> Dict[str, Any]:
    """torch's `model.lerp(ema, d)` = (1 - d) model + d ema
    (train_t2v_enterance.py:262), as JAX computes it, p + d (e - p), in
    place in `ema`."""
    for (_, e), (_, p) in zip(ts.named_leaves(ema), ts.named_leaves(params)):
        e.sub_(p).mul_(decay).add_(p)
    return ema


def draw(gen: torch.Generator, x0: torch.Tensor, sched: DiffusionSchedule,
         cfg: VideoTrainConfig) -> Dict[str, torch.Tensor]:
    """A step's draws from `gen`: the per-row text drop (uniform < p_zero),
    t ~ randint(0, T) a row and the noise."""
    b, dev = x0.shape[0], x0.device
    return {"drop": torch.rand((b,), generator=gen, device=dev) < cfg.p_zero,
            "t": torch.randint(0, sched.num_timesteps, (b,), generator=gen, device=dev),
            "noise": torch.randn(x0.shape, generator=gen, device=dev, dtype=x0.dtype)}


def make_video_loss(unet_cfg: unet_sd_video.UNetSDVideoConfig, sched: DiffusionSchedule,
                    tcfg: VideoTrainConfig):
    """-> loss_fn(params, batch, draws): rows whose drop is set take the
    null embedding `zero_y_negative`; the mean of the per-sample loss."""

    def loss_fn(params, batch, draws):
        x0 = batch["x0"]
        y = torch.where(draws["drop"][:, None, None], batch["zero_y_negative"], batch["y"])

        def model_fn(xt, t):
            return unet_sd_video.forward(params, unet_cfg, xt.to(x0.dtype), t, y=y,
                                         fps=batch.get("fps"), image=batch.get("image"),
                                         local_image=batch.get("local_image"))

        per = diffusion_loss(model_fn, x0, draws["t"], draws["noise"], sched,
                             mean_type=tcfg.mean_type, loss_type=tcfg.loss_type,
                             use_div_loss=tcfg.use_div_loss)
        return per.mean()

    return loss_fn


def make_video_train_step(unet_cfg: unet_sd_video.UNetSDVideoConfig, sched: DiffusionSchedule,
                          tcfg: VideoTrainConfig, optimizer: Optional[ts.Transform] = None):
    """-> step(state, batch, draws, grads=None) -> (state, loss): one
    optimizer step in place, then the EMA. state: `init_state`'s, made with
    the same `optimizer` (default `make_optimizer(tcfg)`). batch:
      x0   [B, F, H, W, 4]     VAE latents (already scaled)
      y    [B, L, context_dim] text tokens
      fps  [B] int
      zero_y_negative [1, L, context_dim]  the CFG null embedding
      and, for i2vgen, `image` [B, y_dim] and `local_image` [B, H, W, 4].
    draws: {"drop", "t", "noise"} or a torch.Generator (`draw`). `grads`, a
    dict, receives a copy of each gradient under its key path before the
    optimizer uses it up."""
    tx = optimizer or make_optimizer(tcfg)
    loss_fn = make_video_loss(unet_cfg, sched, tcfg)

    def step(state, batch, draws: Union[Dict[str, torch.Tensor], torch.Generator], grads=None):
        params = state["params"]
        if isinstance(draws, torch.Generator):
            draws = draw(draws, batch["x0"], sched, tcfg)
        leaves = ts.leaves(params)
        ts.zero_grad(leaves)
        with torch.enable_grad():
            loss = loss_fn(params, batch, draws)
            loss.backward()
        ts.copy_grads(params, grads)
        new_state = {"params": params, "opt_state": ts.apply_gradients(tx, leaves,
                                                                       state["opt_state"])}
        if tcfg.use_ema:
            new_state["ema"] = ema_update(state["ema"], params, tcfg.ema_decay)
        return new_state, loss.detach()

    return step


def init_state(params: Dict[str, Any], tcfg: VideoTrainConfig,
               optimizer: Optional[ts.Transform] = None) -> Dict[str, Any]:
    """{"params", "opt_state", "ema"}: every leaf requires grad and takes
    the optimizer's state (default `make_optimizer(tcfg)`); the EMA starts
    as a copy of the weights (train_t2v_enterance.py:157-159)."""
    leaves = [p.requires_grad_(True) for p in ts.leaves(params)]
    state = {"params": params, "opt_state": (optimizer or make_optimizer(tcfg)).init(leaves)}
    if tcfg.use_ema:
        state["ema"] = ts.map_leaves(lambda _, p: p.detach().clone(), params)
    return state
