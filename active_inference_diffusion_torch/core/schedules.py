"""Discrete DDPM noise schedules as float32 tensors.

Counterpart of ``active_inference_diffusion_tpu/core/schedules.py``: the
coefficients are computed in float64 numpy and cast to float32 once, exactly
as the JAX package does, so both packages hold identical schedules.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    """Per-timestep coefficients of a discrete DDPM schedule (length K)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor

    @property
    def num_steps(self) -> int:
        return self.betas.shape[0]


def make_betas(num_steps: int, schedule: str, beta_start: float, beta_end: float) -> np.ndarray:
    """Beta schedule; cosine follows Nichol & Dhariwal's alpha-bar construction."""
    if schedule == "cosine":
        s = 0.008
        x = np.linspace(0.0, num_steps, num_steps + 1, dtype=np.float64)
        alphas_cumprod = np.cos(((x / num_steps) + s) / (1 + s) * math.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
        betas = np.clip(betas, 1e-4, 0.999)
    elif schedule == "linear":
        betas = np.linspace(beta_start, beta_end, num_steps, dtype=np.float64)
    else:
        raise ValueError(f"Unknown schedule: {schedule}")
    return betas


def make_schedule(
    num_steps: int,
    schedule: str = "cosine",
    beta_start: float = 1e-4,
    beta_end: float = 0.02,
    device: Optional[torch.device] = None,
) -> DiffusionSchedule:
    """All DDPM coefficients, float64 on the host, float32 on ``device``."""
    betas = make_betas(num_steps, schedule, beta_start, beta_end)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])

    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_mean_coef1 = betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    posterior_mean_coef2 = (
        (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod)
    )

    def arr(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    return DiffusionSchedule(
        betas=arr(betas),
        alphas=arr(alphas),
        alphas_cumprod=arr(alphas_cumprod),
        alphas_cumprod_prev=arr(alphas_cumprod_prev),
        sqrt_alphas_cumprod=arr(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=arr(np.sqrt(1.0 - alphas_cumprod)),
        sqrt_recip_alphas=arr(1.0 / np.sqrt(alphas)),
        posterior_variance=arr(posterior_variance),
        posterior_log_variance_clipped=arr(np.log(np.clip(posterior_variance, 1e-20, None))),
        posterior_mean_coef1=arr(posterior_mean_coef1),
        posterior_mean_coef2=arr(posterior_mean_coef2),
    )


def schedule_from_config(config, device: Optional[torch.device] = None) -> DiffusionSchedule:
    """Build a schedule from a ``DiffusionConfig``."""
    return make_schedule(
        num_steps=config.num_diffusion_steps,
        schedule=config.beta_schedule,
        beta_start=config.beta_start,
        beta_end=config.beta_end,
        device=device,
    )


def extract(coeffs: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, shaped to broadcast against a
    rank-``ndim`` batch tensor."""
    out = coeffs[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))
