"""Shared building blocks: sinusoidal time embedding and adaptive LayerNorm.

Counterpart of ``active_inference_diffusion_tpu/models/common.py:22-56``.
LayerNorm epsilon is 1e-6 (the Flax default), not torch's 1e-5.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6


class SinusoidalPositionEmbeddings(nn.Module):
    """Sinusoidal time embedding with a learnable frequency scale: sin then
    cos, exponent ``log(1e4) / (half - 1)``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.freq_scale = nn.Parameter(torch.ones(1))

    def forward(self, time: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        exponent = math.log(10000.0) / (half_dim - 1)
        freqs = torch.exp(
            torch.arange(half_dim, dtype=time.dtype, device=time.device) * -exponent
        )
        freqs = freqs * self.freq_scale
        args = time[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class AdaptiveLayerNorm(nn.Module):
    """LayerNorm without affine parameters, modulated by the conditioning:
    ``LN(x) * (1 + scale) + shift`` with ``[scale, shift] =
    adaLN_modulation(silu(cond))``."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.adaLN_modulation = nn.Linear(hidden_dim, 2 * hidden_dim)

    def forward(self, x: torch.Tensor, conditioning: torch.Tensor) -> torch.Tensor:
        scale, shift = self.adaLN_modulation(F.silu(conditioning)).chunk(2, dim=-1)
        normed = F.layer_norm(x, (self.hidden_dim,), eps=LN_EPS)
        return normed * (1.0 + scale) + shift
