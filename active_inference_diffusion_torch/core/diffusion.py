"""Diffusion math as plain tensor functions: the learnable continuous-time
process of the ELBO and the discrete forward and reverse steps of the sweep.

Counterpart of ``active_inference_diffusion_tpu/core/diffusion.py:26-183``,
``generate_latents`` (:137-183) included. The learnable quantities (latent prior mean and log-std, log-SNR bounds)
are the parameters of a small module, ``DiffusionParams`` (the JAX
``diffusion`` parameter group). Noise is an explicit argument, as in the JAX
package: the caller draws it from its own ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from .schedules import DiffusionSchedule, extract


class DiffusionParams(nn.Module):
    """The learnable diffusion parameters: a Gaussian latent prior (mean 0,
    log-std 0 at init) and the log-SNR range [-10, 10] of continuous time."""

    def __init__(self, latent_dim: int):
        super().__init__()
        self.latent_prior_mean = nn.Parameter(torch.zeros(latent_dim))
        self.latent_prior_log_std = nn.Parameter(torch.zeros(latent_dim))
        self.log_snr_min = nn.Parameter(torch.tensor(-10.0))
        self.log_snr_max = nn.Parameter(torch.tensor(10.0))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None) -> None:
        self.latent_prior_mean.zero_()
        self.latent_prior_log_std.zero_()
        self.log_snr_min.fill_(-10.0)
        self.log_snr_max.fill_(10.0)


def compute_log_snr(params: DiffusionParams, t: torch.Tensor) -> torch.Tensor:
    """Log signal-to-noise ratio over continuous time t in [0, 1]."""
    return params.log_snr_min + (params.log_snr_max - params.log_snr_min) * (1.0 - t)


def continuous_q_sample(
    params: DiffusionParams, z_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Continuous-time forward diffusion: alpha = sigmoid(log_snr),
    sigma = sigmoid(-log_snr), z_t = sqrt(alpha) z_0 + sqrt(sigma) eps."""
    log_snr = compute_log_snr(params, t)
    alpha = torch.sigmoid(log_snr)[:, None]
    sigma = torch.sigmoid(-log_snr)[:, None]
    z_noisy = torch.sqrt(alpha) * z_start + torch.sqrt(sigma) * noise
    return z_noisy, {"log_snr": log_snr, "alpha": alpha, "sigma": sigma}


def compute_loss_weight(params: DiffusionParams, t: torch.Tensor) -> torch.Tensor:
    """Score-matching weight exp(-log_snr^2 / 8) (sin(pi t) + 0.1), which
    emphasises the middle of the time range."""
    log_snr = compute_log_snr(params, t)
    return torch.exp(-0.5 * (log_snr**2) / 4.0) * (torch.sin(t * math.pi) + 0.1)


def sample_latent_prior(params: DiffusionParams, eps: torch.Tensor) -> torch.Tensor:
    """A draw of the learned Gaussian latent prior from standard normals
    ``eps`` (B, D)."""
    std = torch.exp(params.latent_prior_log_std)
    return params.latent_prior_mean[None, :] + std[None, :] * eps


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


class DenoiseResult(NamedTuple):
    latent: torch.Tensor  # (B, D) the final latent z_0
    trajectory: Optional[torch.Tensor]  # (K+1, B, D) the start and every step's z, if asked


def reverse_sweep(
    schedule: DiffusionSchedule,
    score_at: Callable[[int, torch.Tensor], torch.Tensor],
    z_init: torch.Tensor,
    noise: Optional[torch.Tensor],
    num_steps: int,
    deterministic: bool = False,
    return_trajectory: bool = False,
) -> DenoiseResult:
    """``num_steps`` p_sample steps from ``z_init`` over the schedule's
    tail t = K-1..0, as the JAX package's reverse ``lax.scan``: step i
    takes the score ``score_at(i, z)`` and the standard normals
    ``noise[i]`` ((K, B, D); None when ``deterministic``). Plain tensor
    ops, so autograd follows the whole chain."""
    if noise is None and not deterministic:
        raise ValueError("a stochastic sweep needs its per-step noise")
    b = z_init.shape[0]
    z = z_init
    trajectory = [z_init]
    for i in range(num_steps):
        t = torch.full((b,), num_steps - 1 - i, dtype=torch.int64, device=z.device)
        z = p_sample(schedule, z, t, score_at(i, z), None if deterministic else noise[i],
                     deterministic=deterministic)
        if return_trajectory:
            trajectory.append(z)
    return DenoiseResult(z, torch.stack(trajectory) if return_trajectory else None)


def generate_latents(
    schedule: DiffusionSchedule,
    score_fn: Callable[[torch.Tensor, torch.Tensor, Optional[torch.Tensor]], torch.Tensor],
    z_init: torch.Tensor,
    noise: Optional[torch.Tensor],
    observation: Optional[torch.Tensor] = None,
    num_steps: Optional[int] = None,
    deterministic: bool = False,
    return_trajectory: bool = False,
) -> DenoiseResult:
    """Reverse-diffusion belief generation: ``score_fn(z, t_float,
    observation)`` at each step of the schedule's tail of ``num_steps``
    (default the whole schedule), from the start ``z_init`` (B, D) with the
    per-step standard normals ``noise`` (K, B, D), the draws the JAX
    function takes from its key's two halves."""
    k = schedule.num_steps if num_steps is None else num_steps
    if k > schedule.num_steps:
        raise ValueError(f"num_steps={k} exceeds schedule length {schedule.num_steps}")
    b = z_init.shape[0]

    def score_at(i: int, z: torch.Tensor) -> torch.Tensor:
        t = torch.full((b,), float(k - 1 - i), dtype=z.dtype, device=z.device)
        return score_fn(z, t, observation)

    return reverse_sweep(schedule, score_at, z_init, noise, k, deterministic, return_trajectory)
