"""Gaussian policy conditioned on diffusion latents.

Counterpart of ``active_inference_diffusion_tpu/models/policy.py:21-140``
(``gaussian_kl`` :48-62).
Distributions are (mean, log_std) pairs with plain helper functions. The
standard-normal noise of a sample is an explicit argument; the caller draws
it from its own ``torch.Generator``. ``HierarchicalDiffusionPolicy`` is not
ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import LN_EPS, flax_init_, orthogonal_init, xavier_uniform_


class PolicyDist(NamedTuple):
    """Diagonal Gaussian policy distribution parameters."""

    mean: torch.Tensor  # (B, A)
    log_std: torch.Tensor  # (B, A)

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(self.log_std)

    def sample(self, eps: torch.Tensor) -> torch.Tensor:
        """Reparameterised sample from standard-normal ``eps``."""
        return self.mean + self.std * eps

    def log_prob(self, action: torch.Tensor) -> torch.Tensor:
        """Per-dimension Gaussian log-prob, summed over action dims."""
        var = torch.exp(2.0 * self.log_std)
        logp = -0.5 * (
            (action - self.mean) ** 2 / var + 2.0 * self.log_std + math.log(2 * math.pi)
        )
        return logp.sum(dim=-1)

    def entropy(self) -> torch.Tensor:
        """Per-dimension entropy, summed over action dims."""
        return (0.5 * (1.0 + math.log(2 * math.pi)) + self.log_std).sum(dim=-1)


def gaussian_kl(p: PolicyDist, q: PolicyDist) -> torch.Tensor:
    """KL(p || q) of two diagonal Gaussians, summed over action dims -> (B,).
    The policy anchor takes it on the pre-tanh distributions: tanh is a
    fixed bijection, so the squashed policies' KL is the same."""
    var_p = torch.exp(2.0 * p.log_std)
    var_q = torch.exp(2.0 * q.log_std)
    kl = q.log_std - p.log_std + (var_p + (p.mean - q.mean) ** 2) / (2.0 * var_q) - 0.5
    return kl.sum(dim=-1)


def tanh_squash_log_prob(log_prob: torch.Tensor, pre_tanh_action: torch.Tensor) -> torch.Tensor:
    """Tanh-squashing log-prob correction."""
    correction = 2.0 * (
        math.log(2.0) - pre_tanh_action - F.softplus(-2.0 * pre_tanh_action)
    )
    return log_prob - correction.sum(dim=-1)


class DiffusionConditionedPolicy(nn.Module):
    """Gaussian policy p(a | z) with a state-dependent std head."""

    def __init__(
        self,
        latent_dim: int,
        action_dim: int,
        hidden_dim: int = 256,
        num_layers: int = 3,
        log_std_min: float = -20.0,
        log_std_max: float = 2.0,
    ):
        super().__init__()
        self.log_std_min = log_std_min
        self.log_std_max = log_std_max
        self.enc_fc1 = nn.Linear(latent_dim, hidden_dim)
        self.enc_ln = nn.LayerNorm(hidden_dim, eps=LN_EPS)
        self.enc_fc2 = nn.Linear(hidden_dim, hidden_dim)
        self.trunk_fc = nn.ModuleList(
            nn.Linear(hidden_dim, hidden_dim) for _ in range(num_layers)
        )
        self.trunk_ln = nn.ModuleList(
            nn.LayerNorm(hidden_dim, eps=LN_EPS) for _ in range(num_layers)
        )
        self.mean_fc1 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.mean_fc2 = nn.Linear(hidden_dim // 2, action_dim)
        self.std_fc1 = nn.Linear(hidden_dim, hidden_dim // 2)
        self.std_fc2 = nn.Linear(hidden_dim // 2, action_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initialisation: xavier-uniform kernels, orthogonal on the
        two output layers, zero biases, unit LayerNorm scales."""
        flax_init_(self, generator, xavier_uniform_)
        orthogonal_init(1.0)(self.mean_fc2.weight, generator)
        orthogonal_init(1.0)(self.std_fc2.weight, generator)

    def forward(self, z: torch.Tensor) -> PolicyDist:
        h = self.enc_fc2(F.relu(self.enc_ln(self.enc_fc1(z))))
        t = h
        for fc, ln in zip(self.trunk_fc, self.trunk_ln):
            t = F.relu(ln(fc(t)))
        h = h + t
        mean = self.mean_fc2(F.relu(self.mean_fc1(h)))
        log_std = self.std_fc2(F.relu(self.std_fc1(h)))
        log_std = torch.clamp(log_std, self.log_std_min, self.log_std_max)
        return PolicyDist(mean=mean, log_std=log_std)


def sample_action(
    dist: PolicyDist,
    eps: Optional[torch.Tensor],
    deterministic: bool = False,
    squash: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Action and its log-prob. ``eps`` is the standard-normal draw of a
    stochastic sample; the mean is taken when ``deterministic`` or ``eps`` is
    None."""
    pre_action = dist.mean if (deterministic or eps is None) else dist.sample(eps)
    log_prob = dist.log_prob(pre_action)
    if squash:
        return torch.tanh(pre_action), tanh_squash_log_prob(log_prob, pre_action)
    return pre_action, log_prob
