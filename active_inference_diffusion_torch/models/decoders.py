"""Observation decoder and the reward and continuation heads.

Counterpart of ``active_inference_diffusion_tpu/models/decoders.py``:
``StateDecoder`` (:19-39), ``RewardPredictor`` (:57-75),
``ContinuationPredictor`` (:78-92) and ``reward_log_prob`` (:95-99).
``FeatureDecoder`` comes with the pixel slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import LN_EPS, dropout, flax_init_

DECODER_DROPOUT = 0.2


class StateDecoder(nn.Module):
    """Latent -> state-observation decoder with a skip connection: three
    blocks of Linear, LayerNorm (affine, eps 1e-6), silu and dropout 0.2,
    then a Linear head; h2 = block1(h1) + h1.

    Dropout follows the ``train`` argument, as in the Flax module, and not
    ``nn.Module.training``: torch modules start in training mode, and an
    act-time refinement must not drop units because of it. In training the
    caller hands in the three blocks' keep-masks (``dropout_masks``)."""

    def __init__(self, latent_dim: int, observation_dim: int, hidden_dim: int = 512):
        super().__init__()
        self.widths = (2 * hidden_dim, 2 * hidden_dim, hidden_dim)
        fan_ins = (latent_dim, 2 * hidden_dim, 2 * hidden_dim)
        for i, (fan_in, fan_out) in enumerate(zip(fan_ins, self.widths)):
            setattr(self, f"b{i}_fc", nn.Linear(fan_in, fan_out))
            setattr(self, f"b{i}_ln", nn.LayerNorm(fan_out, eps=LN_EPS))
        self.out = nn.Linear(hidden_dim, observation_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

    def _block(self, x: torch.Tensor, i: int, keep: Optional[torch.Tensor]) -> torch.Tensor:
        h = F.silu(getattr(self, f"b{i}_ln")(getattr(self, f"b{i}_fc")(x)))
        return dropout(h, keep, DECODER_DROPOUT)

    def forward(
        self,
        latent: torch.Tensor,
        *,
        train: bool = False,
        dropout_masks: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        if train and dropout_masks is None:
            raise ValueError("StateDecoder(train=True) needs the three blocks' dropout masks")
        masks = dropout_masks if train else (None, None, None)
        h1 = self._block(latent, 0, masks[0])
        h2 = self._block(h1, 1, masks[1]) + h1
        return self.out(self._block(h2, 2, masks[2]))


class RewardPredictor(nn.Module):
    """Latent -> (reward mean, reward std): Linear, LayerNorm, relu, Linear
    to hidden/2, relu, Linear to 2; std = exp(clip(raw, -5, 2))."""

    def __init__(self, latent_dim: int, hidden_dim: int = 512):
        super().__init__()
        self.fc1 = nn.Linear(latent_dim, hidden_dim)
        self.ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.out = nn.Linear(hidden_dim // 2, 2)

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

    def forward(self, latent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.fc2(F.relu(self.ln(self.fc1(latent)))))
        params = self.out(h)
        return params[:, 0], torch.exp(torch.clamp(params[:, 1], -5.0, 2.0))


class ContinuationPredictor(nn.Module):
    """Latent -> continuation logit c(z): Linear, LayerNorm, relu, Linear to 1."""

    def __init__(self, latent_dim: int, hidden_dim: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(latent_dim, hidden_dim)
        self.ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.out = nn.Linear(hidden_dim, 1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        return self.out(F.relu(self.ln(self.fc1(latent))))[:, 0]


def reward_log_prob(mean: torch.Tensor, std: torch.Tensor, rewards: torch.Tensor) -> torch.Tensor:
    """Gaussian log-likelihood of rewards under the predictor."""
    var = std**2
    return -0.5 * ((rewards - mean) ** 2 / var + torch.log(2.0 * math.pi * var))
