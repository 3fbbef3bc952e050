"""Function-space epistemic value: MINE over Jacobian probes of the decoder,
the state estimator.

Counterpart of ``active_inference_diffusion_tpu/core/epistemic.py``. The
probes are exact directional derivatives of the decoder (``torch.func.jvp``;
the reference's finite differences are their eps -> 0 limit). The MINE
running mean is explicit state threaded through calls. Every draw (latent
samples, probe directions, the marginal's permutations, dropout keep-masks)
comes in a ``MineDraws``. ``PixelJacobianFeatures`` comes with the pixel
slice.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.common import LN_EPS, dropout, flax_init_

MINE_DROPOUT = 0.1
# Probe features, the MINE head's hidden width, the latent features.
_FEATURES, _HIDDEN, _LATENT_FEATURES = 128, 512, 128


class EmaLogMeanExp(torch.autograd.Function):
    """log mean exp(x) whose gradient divides by the EMA of mean exp(x)
    instead of this batch's, exp(x) / ((running_mean + 1e-6) n): MINE's
    bias-corrected gradient. No gradient reaches the running mean."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, running_mean: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, running_mean)
        return torch.logsumexp(x.reshape(-1), dim=0) - torch.log(
            torch.full((), float(x.numel()), dtype=x.dtype, device=x.device)
        )

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, running_mean = ctx.saved_tensors
        return g * torch.exp(x) / ((running_mean + 1e-6) * x.numel()), None


ema_logmeanexp = EmaLogMeanExp.apply


def ema_loss(
    x: torch.Tensor, running_mean: torch.Tensor, alpha: float = 0.01
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MINE's marginal term and the updated EMA of mean exp(x) (the batch
    value itself while the EMA is still 0)."""
    with torch.no_grad():
        t_exp = torch.exp(torch.logsumexp(x.reshape(-1), dim=0) - torch.log(
            torch.full((), float(x.numel()), dtype=x.dtype, device=x.device)))
        new_running_mean = torch.where(
            running_mean == 0.0, t_exp, alpha * t_exp + (1.0 - alpha) * running_mean
        )
    return ema_logmeanexp(x, new_running_mean), new_running_mean


class EstimatorMasks(NamedTuple):
    """Dropout keep-masks of one training call of the estimator, (N, 512)
    each, in the Flax module's call order."""

    proj: torch.Tensor  # after the Jacobian projector's first layer
    joint_fc1: torch.Tensor  # the MINE head on the joint pairs
    joint_fc2: torch.Tensor
    marginal_fc1: torch.Tensor  # the MINE head on the shuffled pairs
    marginal_fc2: torch.Tensor


class StateJacobianFeatures(nn.Module):
    """Per-probe features: Linear 128, relu, Linear 256, relu, Linear 128."""

    def __init__(self, observation_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(observation_dim, 128)
        self.fc2 = nn.Linear(128, 256)
        self.fc3 = nn.Linear(256, _FEATURES)

    def forward(self, diff: torch.Tensor) -> torch.Tensor:
        return self.fc3(F.relu(self.fc2(F.relu(self.fc1(diff)))))


class EpistemicStatisticsNetwork(nn.Module):
    """The probe features of every direction (one shared extractor),
    concatenated and projected (Linear 512, LayerNorm, relu, dropout,
    Linear ``aggregator_output_dim``), and the latent features (Linear 128,
    relu, Linear 128)."""

    def __init__(self, observation_dim: int, latent_dim: int, ntk_samples: int = 4,
                 aggregator_output_dim: int = 256):
        super().__init__()
        self.ntk_samples = ntk_samples
        self.state_feat = StateJacobianFeatures(observation_dim)
        self.proj_fc1 = nn.Linear(_FEATURES * ntk_samples, _HIDDEN)
        self.proj_ln = nn.LayerNorm(_HIDDEN, eps=LN_EPS)
        self.proj_fc2 = nn.Linear(_HIDDEN, aggregator_output_dim)
        self.lat_fc1 = nn.Linear(latent_dim, _LATENT_FEATURES)
        self.lat_fc2 = nn.Linear(_LATENT_FEATURES, _LATENT_FEATURES)

    def forward(
        self, probes: torch.Tensor, z: torch.Tensor, keep: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        jac = torch.cat([self.state_feat(probes[i]) for i in range(self.ntk_samples)], dim=-1)
        h = dropout(F.relu(self.proj_ln(self.proj_fc1(jac))), keep, MINE_DROPOUT)
        return self.proj_fc2(h), self.lat_fc2(F.relu(self.lat_fc1(z)))


class MineStatisticsHead(nn.Module):
    """T(x, z): Linear 512, relu, dropout, Linear 512, relu, dropout, Linear 1."""

    def __init__(self, in_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, _HIDDEN)
        self.fc2 = nn.Linear(_HIDDEN, _HIDDEN)
        self.fc3 = nn.Linear(_HIDDEN, 1)

    def forward(self, combined: torch.Tensor, keep1=None, keep2=None) -> torch.Tensor:
        h = dropout(F.relu(self.fc1(combined)), keep1, MINE_DROPOUT)
        h = dropout(F.relu(self.fc2(h)), keep2, MINE_DROPOUT)
        return self.fc3(h)


class FunctionSpaceEpistemicEstimator(nn.Module):
    """The statistics networks, the MINE head and the learnable perturbation
    scale (read only by finite-difference probes; kept for the parameter
    tree's shape, as in the JAX module)."""

    def __init__(self, observation_dim: int, latent_dim: int, is_pixel: bool = False,
                 ntk_samples: int = 4, aggregator_output_dim: int = 256):
        super().__init__()
        if is_pixel:
            raise NotImplementedError("PixelJacobianFeatures comes with the pixel slice (ROADMAP A11)")
        self.ntk_samples = ntk_samples
        self.perturbation_scale = nn.Parameter(torch.tensor(0.1))
        self.stats = EpistemicStatisticsNetwork(
            observation_dim, latent_dim, ntk_samples, aggregator_output_dim
        )
        self.mine = MineStatisticsHead(aggregator_output_dim + _LATENT_FEATURES)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator)
        self.perturbation_scale.fill_(0.1)

    def forward(
        self,
        probes: torch.Tensor,
        z: torch.Tensor,
        marginal_perm: torch.Tensor,
        masks: Optional[EstimatorMasks] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t_joint (N,), t_marginal (N,)); ``masks`` given means training."""
        m = masks if masks is not None else EstimatorMasks(None, None, None, None, None)
        jac, lat = self.stats(probes, z, m.proj)
        t_joint = self.mine(torch.cat([jac, lat], dim=-1), m.joint_fc1, m.joint_fc2)[:, 0]
        t_marginal = self.mine(
            torch.cat([jac[marginal_perm], lat], dim=-1), m.marginal_fc1, m.marginal_fc2
        )[:, 0]
        return t_joint, t_marginal


class MineDraws(NamedTuple):
    """The draws of one ``estimate_epistemic_value`` call."""

    noise: torch.Tensor  # (S, B, D) N(0, I): latent samples around the predicted mean
    directions: torch.Tensor  # (ntk, S B, D) N(0, I), normalised into probe directions
    perms: torch.Tensor  # (S, B) int64: a permutation of the batch per sample block
    masks: Optional[EstimatorMasks]  # keep-masks in training, None in evaluation


def draw_mine(
    batch_size: int, latent_dim: int, num_samples: int, ntk_samples: int,
    generator: torch.Generator, device,
) -> MineDraws:
    """The draws of one training call of ``estimate_epistemic_value``."""
    n = num_samples * batch_size
    noise = torch.randn((num_samples, batch_size, latent_dim), generator=generator, device=device)
    directions = torch.randn((ntk_samples, n, latent_dim), generator=generator, device=device)
    perms = torch.stack([
        torch.randperm(batch_size, generator=generator, device=device) for _ in range(num_samples)
    ])
    masks = EstimatorMasks(*(
        torch.rand((n, _HIDDEN), generator=generator, device=device) >= MINE_DROPOUT
        for _ in EstimatorMasks._fields
    ))
    return MineDraws(noise, directions, perms, masks)


class EpistemicResult(NamedTuple):
    value: torch.Tensor  # (B,) the MI lower bound clamped at 0, broadcast over the batch
    mi_lower_bound: torch.Tensor  # scalar
    running_mean: torch.Tensor  # the updated EMA state
    metrics: Dict[str, torch.Tensor]


def compute_jacobian_probes(
    decoder_fn: Callable[[torch.Tensor], torch.Tensor],
    z: torch.Tensor,
    directions: torch.Tensor,
) -> torch.Tensor:
    """Directional derivatives of the decoder at ``z`` (N, D) along the
    unit directions of ``directions`` (ntk, N, D): (ntk, N, *obs). The
    decoder acts row by row, so all directions run as one jvp over the
    tiled batch."""
    dirs = directions / (torch.linalg.vector_norm(directions, dim=-1, keepdim=True) + 1e-12)
    ntk, n = dirs.shape[:2]
    _, out = torch.func.jvp(decoder_fn, (z.repeat(ntk, 1),), (dirs.reshape(ntk * n, -1),))
    return out.reshape(ntk, n, *out.shape[1:])


def estimate_epistemic_value(
    estimator: FunctionSpaceEpistemicEstimator,
    decoder_fn: Callable[[torch.Tensor], torch.Tensor],
    next_latent_mean: torch.Tensor,
    next_latent_logvar: torch.Tensor,
    draws: MineDraws,
    running_mean: torch.Tensor,
    alpha: float = 0.01,
) -> EpistemicResult:
    """MINE lower bound on I(o; theta | z): latent samples from the
    predicted next-latent Gaussian, decoder Jacobian probes at them (no
    gradient), the statistics network on joint pairs and on pairs whose
    probe features are shuffled within each sample block. Training when
    ``draws.masks`` is given."""
    batch_size = next_latent_mean.shape[0]
    num_samples = draws.noise.shape[0]
    std = torch.exp(0.5 * next_latent_logvar)
    z_all = (next_latent_mean[None] + draws.noise * std[None]).reshape(num_samples * batch_size, -1)
    with torch.no_grad():
        probes = compute_jacobian_probes(decoder_fn, z_all.detach(), draws.directions)
    offsets = (torch.arange(num_samples, device=draws.perms.device) * batch_size)[:, None]
    marginal_perm = (draws.perms + offsets).reshape(-1)
    t_joint, t_marginal = estimator(probes, z_all, marginal_perm, draws.masks)
    t_marginal_lme, new_running_mean = ema_loss(t_marginal, running_mean, alpha)
    mi_lower_bound = torch.mean(t_joint) - t_marginal_lme
    value = torch.clamp(mi_lower_bound.expand(batch_size), min=0.0)
    metrics = {
        "epistemic/mi_estimate": mi_lower_bound,
        "epistemic/joint_term": torch.mean(t_joint),
        "epistemic/marginal_term": t_marginal_lme,
        "epistemic/running_mean": new_running_mean,
    }
    return EpistemicResult(value, mi_lower_bound, new_running_mean, metrics)
