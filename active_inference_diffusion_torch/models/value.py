"""Time-conditioned value network V(s, t).

Counterpart of ``active_inference_diffusion_tpu/models/value.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import LN_EPS, SinusoidalPositionEmbeddings, flax_init_


class ValueNetwork(nn.Module):
    """A sinusoidal time embedding through ``time_fc`` and relu, concatenated
    to the state, then ``num_layers`` blocks of Linear, LayerNorm and relu
    and a scalar head; returns (N, 1)."""

    def __init__(self, state_dim: int, hidden_dim: int = 256, time_embed_dim: int = 128,
                 num_layers: int = 3):
        super().__init__()
        self.num_layers = num_layers
        self.time_sin = SinusoidalPositionEmbeddings(time_embed_dim)
        self.time_fc = nn.Linear(time_embed_dim, time_embed_dim)
        widths = [state_dim + time_embed_dim] + [hidden_dim] * num_layers
        for i in range(num_layers):
            setattr(self, f"fc{i}", nn.Linear(widths[i], widths[i + 1]))
            setattr(self, f"ln{i}", nn.LayerNorm(hidden_dim, eps=LN_EPS))
        self.out = nn.Linear(hidden_dim, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)
        with torch.no_grad():
            self.time_sin.freq_scale.fill_(1.0)

    def forward(self, state: torch.Tensor, time: torch.Tensor) -> torch.Tensor:
        t_emb = F.relu(self.time_fc(self.time_sin(time)))
        h = torch.cat([state, t_emb], dim=-1)
        for i in range(self.num_layers):
            h = F.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(h)))
        return self.out(h)
