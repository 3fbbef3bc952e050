"""Discrete forward and reverse diffusion steps as plain tensor functions.

Counterpart of ``active_inference_diffusion_tpu/core/diffusion.py:79-129``.
Noise is an explicit argument, as in the JAX package: the caller draws it
from its own ``torch.Generator``.
"""

from __future__ import annotations

import torch

from .schedules import DiffusionSchedule, extract


def q_sample(
    schedule: DiffusionSchedule,
    z_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """Discrete forward diffusion q(z_t | z_0)."""
    a = extract(schedule.sqrt_alphas_cumprod, t, z_start.ndim)
    b = extract(schedule.sqrt_one_minus_alphas_cumprod, t, z_start.ndim)
    return a * z_start + b * noise


def posterior_mean(
    schedule: DiffusionSchedule,
    z_start: torch.Tensor,
    z_t: torch.Tensor,
    t: torch.Tensor,
) -> torch.Tensor:
    """Posterior mean of q(z_{t-1} | z_t, z_0)."""
    c1 = extract(schedule.posterior_mean_coef1, t, z_start.ndim)
    c2 = extract(schedule.posterior_mean_coef2, t, z_t.ndim)
    return c1 * z_start + c2 * z_t


def p_sample(
    schedule: DiffusionSchedule,
    z_t: torch.Tensor,
    t: torch.Tensor,
    score: torch.Tensor,
    noise: torch.Tensor,
    deterministic: bool = False,
) -> torch.Tensor:
    """One reverse-diffusion step with the score-based update rule.

    Predicts z_0 from the score, then samples the posterior. ``noise`` is
    standard normal shaped like ``z_t``; it is ignored at t == 0 or when
    ``deterministic``.
    """
    sqrt_one_minus_acp = extract(schedule.sqrt_one_minus_alphas_cumprod, t, z_t.ndim)
    sqrt_recip_alpha = extract(schedule.sqrt_recip_alphas, t, z_t.ndim)

    predicted_z_start = (z_t + sqrt_one_minus_acp * score) * sqrt_recip_alpha
    mean = posterior_mean(schedule, predicted_z_start, z_t, t)

    if deterministic:
        return mean

    var = extract(schedule.posterior_variance, t, z_t.ndim)
    nonzero = (t > 0).reshape((-1,) + (1,) * (z_t.ndim - 1)).to(z_t.dtype)
    return mean + nonzero * torch.sqrt(var) * noise
