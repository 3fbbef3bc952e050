"""DiT-style latent score network s_theta(z_t, t, o).

Counterpart of ``active_inference_diffusion_tpu/models/score_network.py:35-192``.
Attention runs over a single token, so it is ``out_proj(v_proj(x))``. The
network keeps the JAX package's split into ``obs_embedding`` /
``time_embedding`` / ``trunk`` so the belief sweep can hoist the first two
out of its K-step loop. The one dropout, after the observation encoder's
first block (rate 0.1), runs only where the caller hands in its keep-mask
(training).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .common import (
    LN_EPS,
    AdaptiveLayerNorm,
    SinusoidalPositionEmbeddings,
    dropout,
    flax_init_,
    xavier_uniform_,
)

OBS_DROPOUT = 0.1


class SingleTokenAttention(nn.Module):
    """Self-attention at sequence length 1: ``out_proj(v_proj(x))``."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.v_proj = nn.Linear(hidden_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_proj(self.v_proj(x))


class DiTBlock(nn.Module):
    """Diffusion-Transformer block with adaptive LayerNorm; the MLP uses the
    tanh approximation of GELU, as Flax's ``nn.gelu`` does."""

    def __init__(self, hidden_dim: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = AdaptiveLayerNorm(hidden_dim)
        self.attention = SingleTokenAttention(hidden_dim)
        self.norm2 = AdaptiveLayerNorm(hidden_dim)
        mlp_hidden = int(hidden_dim * mlp_ratio)
        self.mlp_fc1 = nn.Linear(hidden_dim, mlp_hidden)
        self.mlp_fc2 = nn.Linear(mlp_hidden, hidden_dim)

    def forward(self, x: torch.Tensor, conditioning: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm1(x, conditioning))
        h = self.norm2(x, conditioning)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(h), approximate="tanh"))
        return x + h


class LatentScoreNetwork(nn.Module):
    """Score network s_theta(z_t, t, o) = grad_z log p_t(z | o)."""

    def __init__(
        self,
        latent_dim: int,
        observation_dim: int,
        hidden_dim: int = 256,
        time_embed_dim: int = 128,
        num_layers: int = 6,
        output_scale: float = 1e-3,
    ):
        super().__init__()
        h = hidden_dim
        self.latent_dim = latent_dim
        self.hidden_dim = hidden_dim
        self.num_layers = num_layers
        # sinusoidal time path
        self.time_embed_sin = SinusoidalPositionEmbeddings(time_embed_dim)
        self.time_embed_fc1 = nn.Linear(time_embed_dim, h * 2)
        self.time_embed_fc2 = nn.Linear(h * 2, h)
        # continuous-time MLP path
        self.cont_time_fc1 = nn.Linear(1, time_embed_dim)
        self.cont_time_fc2 = nn.Linear(time_embed_dim, time_embed_dim)
        self.cont_time_fc3 = nn.Linear(time_embed_dim, h)
        self.time_scale = nn.Parameter(torch.ones(1))
        # observation encoder
        self.obs_fc1 = nn.Linear(observation_dim, h)
        self.obs_ln1 = nn.LayerNorm(h, eps=LN_EPS)
        self.obs_fc2 = nn.Linear(h, h)
        self.obs_ln2 = nn.LayerNorm(h, eps=LN_EPS)
        self.obs_fc3 = nn.Linear(h, h)
        self.obs_ln3 = nn.LayerNorm(h, eps=LN_EPS)
        # latent trunk
        self.latent_proj = nn.Linear(latent_dim, h)
        self.blocks = nn.ModuleList(DiTBlock(h) for _ in range(num_layers))
        self.norm_final = AdaptiveLayerNorm(h)
        self.out_fc1 = nn.Linear(h, h // 2)
        self.out_fc2 = nn.Linear(h // 2, latent_dim, bias=False)
        self.output_scale = output_scale
        self.output_multiplier = nn.Parameter(torch.full((1,), output_scale))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initialisation: lecun-normal kernels and zero biases, the
        blocks' MLP xavier-uniform, every adaLN modulation and the score
        head's last layer zero, unit scales, ``output_multiplier`` at
        ``output_scale``."""
        flax_init_(self, generator)
        for block in self.blocks:
            xavier_uniform_(block.mlp_fc1.weight, generator)
            xavier_uniform_(block.mlp_fc2.weight, generator)
        for module in self.modules():
            if isinstance(module, AdaptiveLayerNorm):
                module.adaLN_modulation.weight.zero_()
        self.out_fc2.weight.zero_()
        self.time_scale.fill_(1.0)
        self.time_embed_sin.freq_scale.fill_(1.0)
        self.output_multiplier.fill_(self.output_scale)

    # -- conditioning pieces (hoisted out of the denoise loop) -------------

    def obs_embedding(
        self, observation: torch.Tensor, dropout_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """The observation encoder; ``dropout_mask`` (N, hidden) is the
        keep-mask of its dropout in training, None in evaluation."""
        x = F.silu(self.obs_ln1(self.obs_fc1(observation)))
        x = dropout(x, dropout_mask, OBS_DROPOUT)
        x = F.silu(self.obs_ln2(self.obs_fc2(x)))
        return self.obs_ln3(self.obs_fc3(x))

    def time_embedding(self, time: torch.Tensor, continuous: bool = True) -> torch.Tensor:
        """Embed times of shape (N,). The discrete path (the belief sweep's)
        embeds raw timesteps; the continuous path scales by 999 and adds the
        learned MLP embedding."""

        def sin_path(t):
            return self.time_embed_fc2(F.silu(self.time_embed_fc1(self.time_embed_sin(t))))

        if not continuous:
            return sin_path(time)
        t_sin = sin_path(time * 999.0)
        t_cont = (2.0 * time - 1.0)[:, None]
        t_cont = F.silu(self.cont_time_fc1(t_cont))
        t_cont = F.silu(self.cont_time_fc2(t_cont))
        t_cont = self.cont_time_fc3(t_cont)
        return t_sin + self.time_scale * t_cont

    # -- per-step trunk ---------------------------------------------------

    def trunk(
        self,
        z_t: torch.Tensor,
        conditioning: torch.Tensor,
        time_weight: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Score given precomputed conditioning (t_emb + obs_emb). The score
        is clipped to +-10 before the output multiplier."""
        h = self.latent_proj(z_t)
        for block in self.blocks:
            h = block(h, conditioning)
        h = self.norm_final(h, conditioning)
        h = F.silu(self.out_fc1(h))
        score = torch.clamp(self.out_fc2(h), -10.0, 10.0) * self.output_multiplier
        if time_weight is not None:
            score = score * time_weight
        return score

    def forward(
        self,
        z_t: torch.Tensor,
        time: torch.Tensor,
        observation: Optional[torch.Tensor] = None,
        *,
        continuous: bool = True,
        obs_dropout_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The score; ``obs_dropout_mask`` is the observation encoder's
        dropout keep-mask in training (the Flax module's ``train=True``)."""
        t_emb = self.time_embedding(time, continuous=continuous)
        if observation is not None:
            obs_emb = self.obs_embedding(observation, obs_dropout_mask)
        else:
            obs_emb = torch.zeros(
                (z_t.shape[0], self.hidden_dim), dtype=z_t.dtype, device=z_t.device
            )
        # Annealed output scaling 1/sqrt(t) on the continuous path only
        time_weight = torch.sqrt(1.0 / (1e-5 + time))[:, None] if continuous else None
        return self.trunk(z_t, t_emb + obs_emb, time_weight)
