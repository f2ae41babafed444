"""Diffusion training losses.

Port of `vitron_tpu/models/diffusion/losses.py` (the i2vgen-xl training
objectives, reference: modules/i2vgen-xl/tools/modules/diffusions/
diffusion_ddim.py:367-443): MSE / L1 / charbonnier on eps / x0 / v targets,
an optional per-sample weight, and the temporal-diversity regulariser ("div
loss") for eps-prediction video models. JAX draws the noise from an rng
inside `diffusion_loss` (:37); here the caller hands it over, so a test can
feed JAX's own draws and a trainer draws it from its `torch.Generator`. The
schedule's alphas_cumprod are float32 and their square roots taken in
float32, as JAX does.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from vitron_tpu_torch.models.diffusion.samplers import DiffusionSchedule


def _gather(a: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """a[t] shaped [B, 1, ...] to broadcast over an ndim-dimensional x."""
    v = a[t]
    return v.reshape(v.shape + (1,) * (ndim - v.dim()))


def _alphas(sched: DiffusionSchedule, device) -> torch.Tensor:
    return torch.as_tensor(sched.alphas_cumprod, dtype=torch.float32, device=device)


def diffusion_loss(model_fn: Callable, x0: torch.Tensor, t: torch.Tensor, noise: torch.Tensor,
                   sched: DiffusionSchedule, mean_type: str = "eps", loss_type: str = "mse",
                   weight: Optional[torch.Tensor] = None, use_div_loss: bool = False,
                   charbonnier_eps: float = 1e-6) -> torch.Tensor:
    """Per-sample loss [B] (diffusion_ddim.py:367-421). model_fn(x_t, t) is
    the prediction; x0 [B, F, H, W, C] (video) or [B, H, W, C]; t [B] int;
    noise x0's shape; mean_type 'eps' | 'x0' | 'v'; loss_type 'mse' | 'l1' |
    'charbonnier'."""
    ac = _alphas(sched, x0.device)
    sqrt_ac = _gather(torch.sqrt(ac), t, x0.dim())
    sqrt_1mac = _gather(torch.sqrt(1 - ac), t, x0.dim())
    xt = sqrt_ac * x0 + sqrt_1mac * noise

    out = model_fn(xt, t)
    if mean_type == "eps":
        target = noise
    elif mean_type == "x0":
        target = x0
    elif mean_type == "v":
        target = sqrt_ac * noise - sqrt_1mac * x0
    else:
        raise ValueError(mean_type)

    diff = (out - target).to(torch.float32)
    dims = tuple(range(1, diff.dim()))
    if loss_type == "mse":
        per = (diff ** 2).mean(dims)
    elif loss_type == "l1":
        per = diff.abs().mean(dims)
    elif loss_type == "charbonnier":
        per = torch.sqrt(diff ** 2 + charbonnier_eps).mean(dims)
    else:
        raise ValueError(loss_type)
    if weight is not None:
        per = per * weight

    if use_div_loss and mean_type == "eps" and x0.dim() == 5 and x0.shape[1] > 1:
        # x0 from the eps prediction; penalise a low frame-to-frame std
        # (diffusion_ddim.py:404-417); frames are axis 1 (NTHWC)
        sqrt_recip = _gather(torch.sqrt(1.0 / ac), t, x0.dim())
        sqrt_recipm1 = _gather(torch.sqrt(1.0 / ac - 1.0), t, x0.dim())
        x0_hat = sqrt_recip * xt - sqrt_recipm1 * out
        frame_std = x0_hat.to(torch.float32).std(dim=1, correction=0)
        per = per + 0.001 / (frame_std.reshape(frame_std.shape[0], -1).mean(1) + 1e-4)
    return per


def v_to_eps(v: torch.Tensor, xt: torch.Tensor, t: torch.Tensor,
             sched: DiffusionSchedule) -> torch.Tensor:
    """A v-prediction as eps (for samplers that consume eps)."""
    ac = _alphas(sched, xt.device)
    sa = _gather(torch.sqrt(ac), t, xt.dim())
    sb = _gather(torch.sqrt(1 - ac), t, xt.dim())
    return sa * v + sb * xt
