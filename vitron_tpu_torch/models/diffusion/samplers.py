"""Diffusion samplers and the ldm noise schedules.

Port of `vitron_tpu/models/diffusion/samplers.py`: the beta schedules, the
zero-terminal-SNR rescale and the DDIM arrays (numpy, as in JAX), the
gated-attention alpha schedule, `_x_prev`, `ddim_sample` (eps DDIM with eta,
the gate schedule and the inpainting composite), `plms_sample` (GLIGEN),
`ddim_sample_v` (the v-prediction DDIM of the video pipelines),
`dpm_solver_pp_2m` (DPM-Solver++(2M), trailing timesteps) and `cfg_eps`.
Each JAX `lax.scan` becomes a Python loop, and each `lax.switch` /
`lax.cond` over the multistep order resolves on the host: PLMS takes Heun
on step 0 only, then Adams-Bashforth of order 2, 3 and 4; DPM-Solver++ a
first-order step, then 2M. Step coefficients are float32 scalars computed
in numpy, so the latent math matches the JAX float32 arithmetic. A step's
noise comes in as a tensor or from a `torch.Generator`, so a caller can hand
over the noise the JAX loop draws from its keys.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch


def make_beta_schedule(schedule: str, n_timestep: int, linear_start=1e-4, linear_end=2e-2,
                       cosine_s=8e-3) -> np.ndarray:
    if schedule == "linear":
        # ldm 'linear' is linear in sqrt space
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                           dtype=np.float64) ** 2
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    if schedule == "cosine":
        t = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s) / (1 + cosine_s)
        alphas = np.cos(t * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    raise ValueError(schedule)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale so the final alphas_cumprod is exactly 0 (Lin et al.), as the
    i2vgen / t2v configs request; needs a v-prediction model."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0, a_t = alphas_bar_sqrt[0], alphas_bar_sqrt[-1]
    alphas_bar_sqrt = (alphas_bar_sqrt - a_t) * (a0 / (a0 - a_t))
    alphas_bar = alphas_bar_sqrt ** 2
    alphas = np.concatenate([alphas_bar[:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: np.ndarray
    alphas_cumprod: np.ndarray

    @staticmethod
    def create(schedule: str = "linear", timesteps: int = 1000, linear_start: float = 0.00085,
               linear_end: float = 0.012, zero_terminal_snr: bool = False) -> "DiffusionSchedule":
        betas = make_beta_schedule(schedule, timesteps, linear_start, linear_end)
        if zero_terminal_snr and betas.max() != 1.0:
            betas = rescale_zero_terminal_snr(betas)
        return DiffusionSchedule(betas, np.cumprod(1.0 - betas))

    @property
    def num_timesteps(self) -> int:
        return len(self.betas)

    def q_sample(self, x0: torch.Tensor, t: int, noise: torch.Tensor) -> torch.Tensor:
        """Forward diffusion of x0 to timestep t (one t for the batch)."""
        ac = np.float32(self.alphas_cumprod[t])
        return float(np.sqrt(ac)) * x0 + float(np.sqrt(np.float32(1.0) - ac)) * noise


def make_ddim_arrays(sched: DiffusionSchedule, num_steps: int, eta: float = 0.0):
    """Uniform timestep subset and per-step alphas: (timesteps[S] ascending,
    alphas[S], alphas_prev[S], sigmas[S])."""
    if sched.num_timesteps % num_steps:
        raise ValueError(f"num_steps={num_steps} must divide num_timesteps="
                         f"{sched.num_timesteps} (ldm uniform discretization)")
    c = sched.num_timesteps // num_steps
    ts = np.asarray(list(range(0, sched.num_timesteps, c))) + 1
    ac = sched.alphas_cumprod
    alphas = ac[ts]
    alphas_prev = np.concatenate([[ac[0]], alphas[:-1]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return ts, alphas.astype(np.float32), alphas_prev.astype(np.float32), sigmas.astype(np.float32)


def alpha_generator(length: int, typ: Sequence[float] = (1.0, 0.0, 0.0)) -> np.ndarray:
    """Gated-attention annealing: a stage of alpha 1, a linear decay, then 0."""
    if abs(sum(typ) - 1.0) > 1e-6:
        raise ValueError(f"alpha_type {tuple(typ)} must sum to 1")
    s0 = int(typ[0] * length)
    s1 = int(typ[1] * length)
    s2 = length - s0 - s1
    decay = list(np.arange(0, 1, 1.0 / s1)[::-1]) if s1 else []
    return np.asarray([1.0] * s0 + decay + [0.0] * s2, np.float32)


def _x_prev(x, e_t, a_t, a_prev, sigma=np.float32(0.0), noise=None):
    """DDIM update (get_x_prev_and_pred_x0); the alphas are float32 scalars."""
    one = np.float32(1.0)
    pred_x0 = (x - float(np.sqrt(one - a_t)) * e_t) / float(np.sqrt(a_t))
    x_new = float(np.sqrt(a_prev)) * pred_x0 + float(np.sqrt(one - a_prev - sigma ** 2)) * e_t
    if noise is not None:
        x_new = x_new + float(sigma) * noise
    return x_new, pred_x0


def ddim_sample(eps_fn: Callable, x: torch.Tensor, sched: DiffusionSchedule, num_steps: int,
                eta: float = 0.0, gate_alphas: Optional[np.ndarray] = None,
                mask_blend: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                noise: Optional[torch.Tensor] = None, blend_noise: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """eps DDIM, descending over the uniform timesteps. `eps_fn(x, t, gate)`.
    mask_blend = (keep mask, x0) re-noises x0 to each step's t and keeps it
    where the mask is 1 (the inpainting composite). A step with sigma > 0
    (eta > 0) takes its update noise and, with mask_blend, every step its
    re-noise: from `noise` / `blend_noise` [num_steps, *x.shape] where given,
    else drawn from `gen`."""
    ts, alphas, alphas_prev, sigmas = make_ddim_arrays(sched, num_steps, eta)
    order = np.arange(num_steps)[::-1]
    steps, a_t, a_prev, sig = ts[order], alphas[order], alphas_prev[order], sigmas[order]
    gates = (gate_alphas[np.arange(num_steps)] if gate_alphas is not None
             else np.ones(num_steps, np.float32))

    def draw(given, i):
        if given is not None:
            return given[i]
        return torch.randn(x.shape, generator=gen, dtype=x.dtype, device=x.device)

    for i in range(num_steps):
        t = int(steps[i])
        if mask_blend is not None:
            mask, x0 = mask_blend
            x = sched.q_sample(x0, t, draw(blend_noise, i)) * mask + (1.0 - mask) * x
        e_t = eps_fn(x, t, float(gates[i]))
        x, _ = _x_prev(x, e_t, a_t[i], a_prev[i], sig[i], draw(noise, i) if sig[i] else None)
    return x


def plms_sample(eps_fn: Callable, x: torch.Tensor, sched: DiffusionSchedule, num_steps: int,
                gate_alphas: Optional[np.ndarray] = None,
                mask_blend: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """PLMS: Heun for the first step, then Adams-Bashforth of increasing order
    over the last <= 3 eps estimates. `eps_fn(x, t, gate)`. mask_blend =
    (keep mask, x0, noise [num_steps, *x0.shape]) re-noises x0 to each step's
    t and keeps it where the mask is 1 (the inpainting composite)."""
    ts, alphas, alphas_prev, _ = make_ddim_arrays(sched, num_steps, 0.0)
    order = np.arange(num_steps)[::-1]
    steps = ts[order]
    t_next = np.concatenate([steps[1:], steps[-1:]])
    a_t, a_prev = alphas[order], alphas_prev[order]
    gates = (gate_alphas[np.arange(num_steps)] if gate_alphas is not None
             else np.ones(num_steps, np.float32))
    old_eps = []
    for i in range(num_steps):
        t, gate = int(steps[i]), float(gates[i])
        if mask_blend is not None:
            mask, x0, noise = mask_blend
            x = sched.q_sample(x0, t, noise[i]) * mask + (1.0 - mask) * x
        e_t = eps_fn(x, t, gate)
        if not old_eps:
            x_heun, _ = _x_prev(x, e_t, a_t[i], a_prev[i])
            e_prime = (e_t + eps_fn(x_heun, int(t_next[i]), gate)) / 2
        elif len(old_eps) == 1:
            e_prime = (3 * e_t - old_eps[-1]) / 2
        elif len(old_eps) == 2:
            e_prime = (23 * e_t - 16 * old_eps[-1] + 5 * old_eps[-2]) / 12
        else:
            e_prime = (55 * e_t - 59 * old_eps[-1] + 37 * old_eps[-2] - 9 * old_eps[-3]) / 24
        x, _ = _x_prev(x, e_prime, a_t[i], a_prev[i])
        old_eps = (old_eps + [e_t])[-3:]
    return x


def ddim_sample_v(v_fn: Callable, x: torch.Tensor, sched: DiffusionSchedule, num_steps: int,
                  eta: float = 0.0, percentile: Optional[float] = None,
                  gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """DDIM for a v-prediction model, descending over the timesteps
    clip(1 + arange(0, T, T // S), 0, T - 1):

      x0    = sqrt(ac_t) x - sqrt(1 - ac_t) v
      eps   = (sqrt(1 / ac_t) x - x0) / sqrt(1 / ac_t - 1)
      x    <- sqrt(ac_prev) x0 + sqrt(1 - ac_prev - sigma^2) eps [+ sigma noise]

    `v_fn(x, t)` folds in classifier-free guidance. `percentile` is the
    dynamic x0 clamp. With eta > 0 the noise of each step is drawn from
    `gen` (the JAX loop draws it from its own key: the two agree only at
    eta 0)."""
    T = sched.num_timesteps
    stride = T // num_steps
    steps = np.clip(1 + np.arange(0, T, stride), 0, T - 1)[::-1].copy()
    prev = np.clip(steps - stride, 0, None)
    ac = np.asarray(sched.alphas_cumprod, np.float64)
    a_t = ac[steps].astype(np.float32)
    a_prev = ac[prev].astype(np.float32)
    sig = (eta * np.sqrt((1 - ac[prev]) / (1 - ac[steps]) * (1 - ac[steps] / ac[prev]))
           ).astype(np.float32)
    one = np.float32(1.0)
    for i, t in enumerate(steps):
        at, ap, s = a_t[i], a_prev[i], sig[i]
        v = v_fn(x, int(t))
        x0 = float(np.sqrt(at)) * x - float(np.sqrt(one - at)) * v
        if percentile is not None:
            flat = x0.reshape(x0.shape[0], -1).abs().to(torch.float32)
            q = torch.quantile(flat, percentile, dim=1).clamp(min=1.0)
            q = q.reshape((-1,) + (1,) * (x0.dim() - 1)).to(x0.dtype)
            x0 = torch.clamp(x0, -q, q) / q
        eps_hat = (float(np.sqrt(one / at)) * x - x0) / float(np.sqrt(one / at - one))
        x = float(np.sqrt(ap)) * x0 + float(np.sqrt(one - ap - s * s)) * eps_hat
        if s != 0 and t != 0:
            x = x + float(s) * torch.randn(x.shape, generator=gen, dtype=x.dtype,
                                           device=x.device)
    return x


def dpm_solver_pp_2m(eps_fn: Callable, x: torch.Tensor, sched: DiffusionSchedule,
                     num_steps: int, gate_alphas: Optional[np.ndarray] = None) -> torch.Tensor:
    """DPM-Solver++(2M), eps prediction, final x0 output, over the trailing
    uniform timesteps T - 1 ... 0: a first-order step, then the 2M update
    from the last two x0 estimates. The last step goes to lambda at t = 0
    with sigma_prev = sqrt(1 - ac[0]) * 1e-3. `eps_fn(x, t, gate)`."""
    ac = np.asarray(sched.alphas_cumprod, np.float64)
    T = sched.num_timesteps
    ts = np.linspace(T - 1, 0, num_steps + 1).round().astype(int)[:-1]
    alpha_t = np.sqrt(ac[ts])
    sigma_t = np.sqrt(1 - ac[ts])
    lam = np.log(alpha_t) - np.log(sigma_t)
    alpha_prev = np.concatenate([alpha_t[1:], [1.0]])
    sigma_prev = np.concatenate([sigma_t[1:], [np.sqrt(1 - ac[0]) * 1e-3]])
    lam_prev = np.log(alpha_prev) - np.log(sigma_prev)
    gates = (gate_alphas[np.arange(num_steps)] if gate_alphas is not None
             else np.ones(num_steps, np.float32))
    f32 = np.float32
    a_j, s_j, l_j = alpha_t.astype(f32), sigma_t.astype(f32), lam.astype(f32)
    ap_j, sp_j, lp_j = alpha_prev.astype(f32), sigma_prev.astype(f32), lam_prev.astype(f32)
    x0_prev = None
    for i in range(num_steps):
        eps = eps_fn(x, int(ts[i]), float(gates[i]))
        x0 = (x - float(s_j[i]) * eps) / float(a_j[i])
        h = lp_j[i] - l_j[i]
        if x0_prev is None:
            x0_bar = x0
        else:
            r = (l_j[i] - l_j[i - 1]) / h
            x0_bar = float(1 + 1 / (2 * r)) * x0 - float(1 / (2 * r)) * x0_prev
        x = float(sp_j[i] / s_j[i]) * x - float(ap_j[i] * np.expm1(-h)) * x0_bar
        x0_prev = x0
    return x


def cfg_eps(model_fn: Callable, guidance_scale: float) -> Callable:
    """Classifier-free guidance around `model_fn(x, t, context, gate, **kw)`:
    cond and uncond batched into one call, e_uc + s (e_c - e_uc). Tensor
    keyword arguments with a batch axis are doubled; a scale of 1 makes one
    conditional call."""

    def eps(x, t, context, uc_context, gate, **kw):
        if guidance_scale == 1.0:
            return model_fn(x, t, context, gate, **kw)
        xx = torch.cat([x, x], dim=0)
        if torch.is_tensor(t) and t.dim() > 0:
            tt = torch.cat([t, t])
        else:
            tt = torch.full((xx.shape[0],), int(t), dtype=torch.int64, device=x.device)
        cc = torch.cat([context, uc_context], dim=0)
        kw2 = {k: (torch.cat([v, v], dim=0) if torch.is_tensor(v) and v.dim() > 0 else v)
               for k, v in kw.items()}
        e_c, e_uc = model_fn(xx, tt, cc, gate, **kw2).chunk(2)
        return e_uc + guidance_scale * (e_c - e_uc)

    return eps
