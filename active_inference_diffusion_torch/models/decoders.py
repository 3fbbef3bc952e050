"""Observation decoders.

Counterpart of ``active_inference_diffusion_tpu/models/decoders.py``: only
``StateDecoder`` (:19-39), which the act path's Fokker-Planck refinement
runs. ``FeatureDecoder``, ``RewardPredictor`` and ``ContinuationPredictor``
come with the training and pixel slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import LN_EPS


class StateDecoder(nn.Module):
    """Latent -> state-observation decoder with a skip connection: three
    blocks of Linear, LayerNorm (affine, eps 1e-6), silu and dropout 0.2,
    then a Linear head; h2 = block1(h1) + h1.

    Dropout follows the ``train`` argument, as in the Flax module, and not
    ``nn.Module.training``: torch modules start in training mode, and an
    act-time refinement must not drop units because of it."""

    def __init__(self, latent_dim: int, observation_dim: int, hidden_dim: int = 512):
        super().__init__()
        widths = [(latent_dim, 2 * hidden_dim), (2 * hidden_dim, 2 * hidden_dim),
                  (2 * hidden_dim, hidden_dim)]
        for i, (fan_in, fan_out) in enumerate(widths):
            setattr(self, f"b{i}_fc", nn.Linear(fan_in, fan_out))
            setattr(self, f"b{i}_ln", nn.LayerNorm(fan_out, eps=LN_EPS))
        self.out = nn.Linear(hidden_dim, observation_dim)

    def _block(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return F.silu(getattr(self, f"b{i}_ln")(getattr(self, f"b{i}_fc")(x)))

    def forward(self, latent: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError("decoder dropout in training comes with the training slice")
        h1 = self._block(latent, 0)
        h2 = self._block(h1, 1) + h1
        return self.out(self._block(h2, 2))
