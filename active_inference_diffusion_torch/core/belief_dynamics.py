"""Fokker-Planck belief refinement of the act path.

Counterpart of ``active_inference_diffusion_tpu/core/belief_dynamics.py``:
``FPConfig`` (:36-57) and ``fp_refine_mean`` (:156-194). ``jax.grad``
becomes ``torch.autograd.grad`` with respect to the latent only, so the
parameters collect no ``.grad``; it runs under ``torch.enable_grad()``
because the act path runs under ``no_grad``. The standard-normal noise of
each step comes from the caller's generator, or is handed in. The belief
state update (``belief_update``), ``BeliefDynamics`` and ``belief_entropy``
come with a later slice.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch


class FPConfig(NamedTuple):
    """Static subset of BeliefDynamicsConfig used by the refinement."""

    diffusion_coefficient: float = 0.1
    learning_rate: float = 0.1
    dt: float = 0.01
    min_variance: float = 1e-6
    max_variance: float = 10.0
    use_full_covariance: bool = False
    noise_scale: float = 0.01

    @classmethod
    def from_config(cls, config) -> "FPConfig":
        return cls(
            diffusion_coefficient=config.diffusion_coefficient,
            learning_rate=config.learning_rate,
            dt=config.dt,
            min_variance=config.min_variance,
            max_variance=config.max_variance,
            use_full_covariance=config.use_full_covariance,
            noise_scale=config.noise_scale,
        )


def fp_refine_mean(
    latent: torch.Tensor,
    cfg: FPConfig,
    free_energy_fn: Callable[[torch.Tensor], torch.Tensor],
    num_steps: int = 1,
    generator: Optional[torch.Generator] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched Fokker-Planck mean refinement of belief latents (B, D): per
    step, z <- z - lr * g * dt / (1 + 0.1 |g|) + sqrt(2 D dt) * noise_scale
    * eps with g = grad_z sum F(z), |g| per row. ``free_energy_fn(z) -> (B,)``.
    ``noise`` (num_steps, B, D) standard normal, when given, replaces the
    draw from ``generator``."""
    lr, dt, diff_coef = cfg.learning_rate, cfg.dt, cfg.diffusion_coefficient
    if noise is None:
        noise = torch.randn(
            (num_steps,) + tuple(latent.shape), generator=generator,
            device=latent.device, dtype=latent.dtype,
        )
    noise_std = math.sqrt(2.0 * diff_coef * dt) * cfg.noise_scale
    z = latent.detach()
    for i in range(num_steps):
        with torch.enable_grad():
            zz = z.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(free_energy_fn(zz).sum(), zz)
        grad_norm = torch.sqrt(torch.sum(g**2, dim=-1, keepdim=True) + 1e-12)
        adaptive_dt = dt / (1.0 + 0.1 * grad_norm)
        z = z - lr * g * adaptive_dt + noise_std * noise[i]
    return z
