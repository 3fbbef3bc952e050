"""Observation encoders.

Counterpart of ``active_inference_diffusion_tpu/models/encoders.py``; only
``LatentPosteriorEncoder`` (:358-387) is ported. The pixel encoders
(``DrQV2Encoder`` and the others) come with the pixel slice.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import LN_EPS, flax_init_


class LatentPosteriorEncoder(nn.Module):
    """Amortised Gaussian posterior q(z | o) over the belief latent:
    ``num_layers`` blocks of Linear, LayerNorm (eps 1e-6) and silu at
    ``hidden_dim``, then a Linear to 2 latent_dim split into (mu, logstd),
    logstd clipped to [logstd_min, logstd_max]."""

    def __init__(self, observation_dim: int, latent_dim: int, hidden_dim: int = 256,
                 num_layers: int = 2, logstd_min: float = -6.0, logstd_max: float = 2.0):
        super().__init__()
        self.num_layers = num_layers
        self.logstd_min = logstd_min
        self.logstd_max = logstd_max
        width = observation_dim
        for i in range(num_layers):
            setattr(self, f"fc{i}", nn.Linear(width, hidden_dim))
            setattr(self, f"ln{i}", nn.LayerNorm(hidden_dim, eps=LN_EPS))
            width = hidden_dim
        self.out = nn.Linear(width, 2 * latent_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's Dense defaults: lecun-normal kernels, zero biases, unit
        LayerNorm scales."""
        flax_init_(self, generator)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = obs
        for i in range(self.num_layers):
            h = F.silu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(h)))
        mu, logstd = self.out(h).chunk(2, dim=-1)
        return mu, torch.clamp(logstd, self.logstd_min, self.logstd_max)
