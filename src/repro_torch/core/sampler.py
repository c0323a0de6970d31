"""Diffusion samplers of the port: the VP noise schedules, DDIM /
DPM-Solver-1 (paper Lemma 1), ancestral DDPM, the classifier-free-guidance
combiners and the eps-matching training loss. Reference:
``repro.core.sampler``.

alpha_t = sqrt(alpha_bar_t), sigma_t = sqrt(1 - alpha_bar_t),
lambda_t = log(alpha_t / sigma_t). The schedule lives on the CPU in float32;
``ddim_step`` turns it into two float32 coefficients on the host, so a step
on the card costs no device-to-host synchronization.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class NoiseSchedule:
    """Discrete schedule over T training steps with continuous accessors."""
    T: int
    alpha_bar: torch.Tensor       # [T+1] float32 on the CPU; alpha_bar[0] = 1
    betas: torch.Tensor           # [T+1]; betas[0] = 0

    def alpha(self, t):
        return torch.sqrt(self._ab(t))

    def sigma(self, t):
        return torch.sqrt(1.0 - self._ab(t))

    def lam(self, t):
        ab = self._ab(t)
        return 0.5 * (torch.log(ab) - torch.log1p(-ab))

    def _ab(self, t):
        """Linear interpolation of alpha_bar at (possibly fractional) t."""
        t = torch.as_tensor(t, dtype=torch.float32)
        lo = torch.clamp(torch.floor(t).to(torch.int64), 0, self.T)
        hi = torch.clamp(lo + 1, 0, self.T)
        w = t - lo
        return (1 - w) * self.alpha_bar[lo] + w * self.alpha_bar[hi]


def linear_schedule(T: int = 1000, beta_min: float = 1e-4,
                    beta_max: float = 2e-2) -> NoiseSchedule:
    betas = torch.cat([torch.zeros(1),
                       torch.linspace(beta_min, beta_max, T, dtype=torch.float32)])
    alpha_bar = torch.cumprod(1.0 - betas, dim=0)
    return NoiseSchedule(T, alpha_bar, betas)


def cosine_schedule(T: int = 1000, s: float = 8e-3) -> NoiseSchedule:
    t = torch.arange(T + 1, dtype=torch.float32) / T
    f = torch.cos((t + s) / (1 + s) * math.pi / 2) ** 2
    alpha_bar = torch.clamp(f / f[0], 1e-5, 1.0)
    ab_prev = torch.cat([torch.ones(1), alpha_bar[:-1]])
    betas = torch.clamp(1 - alpha_bar / ab_prev, 0.0, 0.999)
    return NoiseSchedule(T, alpha_bar, betas)


def ddim_timesteps(T: int, M: int, warmup_offset: int = 0) -> torch.Tensor:
    """M+1 decreasing int32 timesteps t_0=T .. t_M=0 (paper Lemma 1 grid).
    ``warmup_offset`` is the reference's unused argument, kept so that
    calls written for it run unchanged.

    Equal, entry for entry, to the reference's
    ``jnp.round(jnp.linspace(T, 0, M + 1))``: that grid lands on exact .5
    values, so its last float32 bit decides the rounding. XLA computes
    ``T * (1 - i * float32(1/M))`` (the division becomes a reciprocal
    multiply), which is reproduced here; ``torch.linspace`` and
    ``np.linspace`` both round differently on some (T, M)."""
    s = torch.arange(M, dtype=torch.float32) * torch.tensor(1.0 / M,
                                                            dtype=torch.float32)
    t = torch.round(T * (1 - s)).to(torch.int32)      # round half to even
    return torch.cat([t, torch.zeros(1, dtype=torch.int32)])


def cfg_combine(eps_c, eps_u, scale):
    """The CFG combiner ``eps_u + w * (eps_c - eps_u)`` in fp32, cast back to
    eps_c's dtype (DESIGN.md §12). The formula ``forward_cfg`` uses; the
    engine's guided steps compute the same with kernel K3
    (:func:`repro_torch.kernels.ops.cfg_epilogue`)."""
    ec = eps_c.float()
    eu = eps_u.float()
    return (eu + scale * (ec - eu)).to(eps_c.dtype)


def cfg_delta(eps_c, eps_u):
    """The guidance direction ``eps_c - eps_u`` (fp32): what interleaved
    guidance caches, since it drifts far more slowly across fine steps than
    eps_u itself."""
    return eps_c.float() - eps_u.float()


def cfg_apply_delta(eps_c, delta, scale):
    """Interleaved reuse combiner ``eps_c + (w-1) * delta`` — exactly
    :func:`cfg_combine` when ``delta`` is this step's true eps_c - eps_u."""
    return (eps_c.float() + (scale - 1.0) * delta).to(eps_c.dtype)


def ddim_step(sched: NoiseSchedule, x, eps, t_from, t_to):
    """One Lemma-1 update from t_{m-1}=t_from to t_m=t_to (t_to < t_from),
    computed in float32 and cast back to x's dtype.

    t_from / t_to: numbers (or one-element tensors), or per-lane tensors
    broadcastable against x (``[G, 1, 1, 1]`` for a lane group x
    ``[G, H, W, C]``, the serving engine's lanes at their own steps): each
    lane then takes its own fp32 coefficients, the same per element as the
    scalar form."""
    a_from, a_to = sched.alpha(t_from), sched.alpha(t_to)
    s_from, s_to = sched.sigma(t_from), sched.sigma(t_to)
    # sigma_to * (e^{h} - 1) == a_to*s_from/a_from - s_to exactly (VP param);
    # this form is finite at the t_to = 0 endpoint where lambda -> +inf.
    coef = a_to * s_from / a_from - s_to
    ratio = a_to / a_from
    if coef.numel() == 1:
        coef, ratio = float(coef), float(ratio)
    else:
        coef, ratio = coef.to(x.device), ratio.to(x.device)
    out = ratio * x.float() - coef * eps.float()
    return out.to(x.dtype)


def ddpm_step(sched: NoiseSchedule, x, eps, t, noise):
    """Ancestral DDPM step t -> t-1 (stochastic), in float32 and cast back
    to x's dtype. ``t`` is an int (a 0-d tensor too); as in the reference,
    the noise is added only while ``t > 1``: the last step (t = 1) returns
    the mean."""
    t = int(t)
    beta = sched.betas[t]
    ab = sched.alpha_bar[t]
    alpha = 1.0 - beta
    coef = float(beta / torch.sqrt(1 - ab))
    mean = (x.float() - coef * eps.float()) / float(torch.sqrt(alpha))
    out = mean + float(torch.sqrt(beta)) * noise.float() if t > 1 else mean
    return out.to(x.dtype)


def ddim_sample(eps_fn: Callable, sched: NoiseSchedule, x_T, M: int):
    """eps_fn(x, t) -> eps with t a Python int. Returns x_0."""
    ts = ddim_timesteps(sched.T, M).tolist()
    x = x_T
    for m in range(M):
        x = ddim_step(sched, x, eps_fn(x, ts[m]), ts[m], ts[m + 1])
    return x


def ddpm_sample(eps_fn: Callable, sched: NoiseSchedule, x_T,
                gen: torch.Generator, noise: Optional[Sequence] = None):
    """Ancestral sampling over all T steps, t = T .. 1; eps_fn(x, t) -> eps
    with t a Python int. Each step's noise is a float32 normal draw of x's
    shape from ``gen`` (on gen's device), or ``noise[i]`` for the i-th step
    when ``noise`` is given (the reference's own draws, for parity)."""
    x = x_T
    for i, t in enumerate(range(sched.T, 0, -1)):
        eps = eps_fn(x, t)
        z = (noise[i] if noise is not None else
             torch.randn(x.shape, generator=gen, dtype=torch.float32,
                         device=gen.device))
        x = ddpm_step(sched, x, eps, t, z.to(x.device))
    return x


# ----------------------------------------------------------------------
# diffusion training objective (eps-prediction)
# ----------------------------------------------------------------------

def diffusion_loss(eps_fn: Callable, sched: NoiseSchedule, x0,
                   gen: torch.Generator):
    """Standard eps-matching loss E_t,eps ||eps_theta(x_t, t) - eps||^2: a
    timestep a batch row uniform in [1, T] and eps ~ N(0, 1) of x0's shape,
    both drawn from ``gen`` on its device, then :func:`diffusion_loss_at`."""
    B = x0.shape[0]
    t = torch.randint(1, sched.T + 1, (B,), generator=gen, device=gen.device)
    eps = torch.randn(x0.shape, generator=gen, dtype=torch.float32,
                      device=gen.device)
    return diffusion_loss_at(eps_fn, sched, x0, t.to(x0.device),
                             eps.to(x0.device))


def diffusion_loss_at(eps_fn: Callable, sched: NoiseSchedule, x0, t, eps):
    """The loss at given draws: t [B] integer timesteps, eps float32 of
    x0's shape; x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps in float32, fed to
    ``eps_fn(x_t in x0's dtype, t)``, and the mean square error of its
    prediction against eps in float32."""
    B = x0.shape[0]
    ab = sched.alpha_bar.to(x0.device)[t.to(x0.device, torch.int64)]
    ab = ab.reshape((B,) + (1,) * (x0.ndim - 1))
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1 - ab) * eps
    pred = eps_fn(xt.to(x0.dtype), t)
    return torch.mean(torch.square(pred.float() - eps))
