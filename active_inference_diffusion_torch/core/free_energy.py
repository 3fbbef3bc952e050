"""Standalone variational free energy with a learnable sensory precision.

Counterpart of ``active_inference_diffusion_tpu/core/free_energy.py``:
F = complexity - accuracy + a score regulariser, with the log-precision an
explicit scalar and its heuristic update rule.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch


def init_free_energy_state(precision_init: float = 1.0, device=None) -> torch.Tensor:
    """The learnable log-precision scalar."""
    return torch.tensor(math.log(precision_init), device=device)


def compute_free_energy(
    log_precision: torch.Tensor,
    states: torch.Tensor,
    observations: torch.Tensor,
    score_fn: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
    current_time: float = 0.0,
    prior_mean: Optional[torch.Tensor] = None,
    prior_std: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """F = complexity - accuracy + 0.01 mean ||score||^2."""
    precision = torch.exp(log_precision)
    if prior_mean is None:
        prior_mean = torch.zeros_like(states)
    complexity = torch.mean(0.5 * torch.sum((states - prior_mean) ** 2 / prior_std**2, dim=-1))
    observation_error = torch.sum((observations - states) ** 2, dim=-1)
    accuracy = -0.5 * precision * torch.mean(observation_error)
    t = torch.full((states.shape[0],), current_time, dtype=states.dtype, device=states.device)
    score_reg = 0.01 * torch.mean(torch.sum(score_fn(states, t, observations) ** 2, dim=-1))
    info = {
        "complexity": complexity,
        "accuracy": -accuracy,
        "observation_error": torch.mean(observation_error),
        "score_regularization": score_reg,
        "precision": precision,
    }
    return complexity - accuracy + score_reg, info


def update_precision(
    log_precision: torch.Tensor, complexity: torch.Tensor, accuracy: torch.Tensor
) -> torch.Tensor:
    """log_precision + 0.01 clip(complexity - accuracy, -1, 1), kept in [-3, 3]."""
    error = torch.clamp(complexity - accuracy, -1.0, 1.0)
    return torch.clamp(log_precision + 0.01 * error, -3.0, 3.0)
