"""Diffusion active inference, acting path: belief sweep and policy.

Counterpart of ``active_inference_diffusion_tpu/core/active_inference.py``
(``__init__`` :64-198, ``apply_policy`` :286-287, ``generate_beliefs``
:431-570, ``act`` :1137-1208). The modules are ``nn.Module``s on an explicit
device and every draw takes an explicit ``torch.Generator``.

The belief sweep always goes through ``ops.denoise.fused_denoise_sweep``: on
a CUDA device it launches the kernel, on the CPU it runs the kernel's plain
version. ``tpu.use_pallas_denoiser`` chose between two TPU implementations
and is not read here. Branches this port does not have yet raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from active_inference_diffusion_tpu.configs.config import ActiveInferenceConfig

from ..models.policy import DiffusionConditionedPolicy, PolicyDist, sample_action
from ..models.score_network import LatentScoreNetwork
from ..ops.denoise import fused_denoise_sweep, packed_trunk_weights
from .schedules import DiffusionSchedule, schedule_from_config

# The largest seed the sweep's noise generator is keyed with.
SEED_BOUND = 2**31 - 1


def check_sweep_supported(config: ActiveInferenceConfig, device: torch.device) -> None:
    """Raise for the sweep variants the CUDA kernel does not have yet. On the
    CPU they run the plain float32 sweep, as the JAX package runs its XLA
    sweep off the TPU."""
    if device.type != "cuda":
        return
    if config.tpu.compute_dtype == "bfloat16":
        raise NotImplementedError("the bfloat16 sweep kernel is not ported yet")
    if config.tpu.denoiser_kernel == "v2":
        raise NotImplementedError("the v2 sweep kernel is not ported yet")


class BeliefInfo(NamedTuple):
    latent: torch.Tensor  # (B, D)
    latent_mean: torch.Tensor  # (D,)
    latent_std: torch.Tensor  # (D,)
    reconstruction_error: torch.Tensor  # scalar
    trajectory: Optional[torch.Tensor]  # always None in this port


class DiffusionActiveInference(nn.Module):
    """Score network, policy and schedule of one agent."""

    def __init__(
        self,
        observation_dim: int,
        action_dim: int,
        latent_dim: int,
        config: ActiveInferenceConfig,
        device: Optional[torch.device] = None,
    ):
        super().__init__()
        if config.pixel_observation:
            raise NotImplementedError("pixel observations are not ported yet")
        self.observation_dim = observation_dim
        self.action_dim = action_dim
        self.latent_dim = latent_dim
        self.config = config
        self.device = torch.device(device) if device is not None else torch.device("cpu")

        self.schedule: DiffusionSchedule = schedule_from_config(config.diffusion, self.device)
        self.score_network = LatentScoreNetwork(
            latent_dim=latent_dim,
            observation_dim=observation_dim,
            hidden_dim=config.hidden_dim,
            num_layers=config.score_num_layers,
        )
        # Explicit flag wins; otherwise corrected mode squashes.
        self.policy_squash = (
            config.policy_squash
            if config.policy_squash is not None
            else config.semantics.mode == "corrected"
        )
        self.policy_network = DiffusionConditionedPolicy(
            latent_dim=latent_dim, action_dim=action_dim, hidden_dim=config.hidden_dim
        )
        self.to(self.device)

    # ------------------------------------------------------------------

    def apply_policy(self, z: torch.Tensor) -> PolicyDist:
        return self.policy_network(z)

    def draw_start(
        self, batch_size: int, generator: torch.Generator
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The sweep's starting latent z0 ~ N(0, I) (B, D) and the seed of its
        in-sweep noise (0-d int64), drawn in that order."""
        z0 = torch.randn(
            (batch_size, self.latent_dim), generator=generator, device=self.device
        )
        seed = torch.randint(
            0, SEED_BOUND, (), generator=generator, device=self.device, dtype=torch.int64
        )
        return z0, seed

    @torch.no_grad()
    def beliefs_from_start(
        self,
        observation: torch.Tensor,
        z0: torch.Tensor,
        seed: torch.Tensor,
        num_steps: Optional[int] = None,
        deterministic: bool = False,
    ) -> BeliefInfo:
        """The reverse-diffusion sweep from ``z0``, conditioned on the
        observations. The observation embedding and all K time embeddings
        are computed once, outside the sweep."""
        cfg = self.config
        k = self.schedule.num_steps if num_steps is None else num_steps
        if k > self.schedule.num_steps:
            raise ValueError(f"num_steps={k} exceeds schedule length {self.schedule.num_steps}")
        check_sweep_supported(cfg, self.device)

        net = self.score_network
        obs_emb = net.obs_embedding(observation)
        timesteps = torch.arange(k - 1, -1, -1, device=self.device)
        t_embs = net.time_embedding(timesteps.to(observation.dtype), continuous=False)
        latent = fused_denoise_sweep(
            self.schedule, packed_trunk_weights(net), z0.contiguous(),
            obs_emb.contiguous(), t_embs.contiguous(), seed,
            num_steps=k, num_layers=cfg.score_num_layers, deterministic=deterministic,
        )

        latent_mean = latent.mean(dim=0)
        if latent.shape[0] > 1:
            latent_std = latent.std(dim=0, correction=1)
        else:
            latent_std = torch.zeros_like(latent_mean)
        return BeliefInfo(
            latent=latent,
            latent_mean=latent_mean,
            latent_std=latent_std,
            reconstruction_error=torch.zeros((), device=self.device),
            trajectory=None,
        )

    def generate_beliefs(
        self,
        generator: torch.Generator,
        observation: torch.Tensor,
        num_steps: Optional[int] = None,
        deterministic: bool = False,
        return_trajectory: bool = False,
    ) -> BeliefInfo:
        """Draw the start, then run ``beliefs_from_start``."""
        if return_trajectory:
            raise NotImplementedError("return_trajectory is not ported yet")
        z0, seed = self.draw_start(observation.shape[0], generator)
        return self.beliefs_from_start(observation, z0, seed, num_steps, deterministic)

    def check_act_supported(self) -> None:
        """Raise for the acting branches this port does not have yet."""
        cfg = self.config
        if cfg.act_from_posterior:
            raise NotImplementedError("act_from_posterior is not ported yet")
        if cfg.plan_candidates > 0:
            raise NotImplementedError("act_planned (plan_candidates > 0) is not ported yet")
        if cfg.belief_dynamics.use_belief_dynamics:
            raise NotImplementedError("belief dynamics refinement is not ported yet")

    @torch.no_grad()
    def act_from_start(
        self,
        observation: torch.Tensor,
        z0: torch.Tensor,
        seed: torch.Tensor,
        generator: Optional[torch.Generator],
        deterministic: bool = False,
        num_steps: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Everything of ``act`` after the start draw: the belief sweep, the
        policy head and its sample. ``generator`` is drawn from only for a
        stochastic policy sample."""
        self.check_act_supported()
        belief = self.beliefs_from_start(
            observation, z0, seed, num_steps, deterministic=self.config.deterministic_beliefs
        )
        dist = self.apply_policy(belief.latent)
        eps = None
        if not deterministic:
            eps = torch.randn(dist.mean.shape, generator=generator, device=self.device)
        action, log_prob = sample_action(
            dist, eps, deterministic=deterministic, squash=self.policy_squash
        )
        info = {
            "action_log_prob": log_prob.mean(),
            "policy_entropy": dist.entropy().mean(),
        }
        return action, info

    def act(
        self,
        generator: torch.Generator,
        observation: torch.Tensor,
        deterministic: bool = False,
        num_steps: Optional[int] = None,
        compute_efe_info: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Belief update via reverse diffusion, then a policy sample."""
        if compute_efe_info:
            raise NotImplementedError("compute_efe_info is not ported yet")
        if observation.dim() == 1:
            observation = observation[None]
        z0, seed = self.draw_start(observation.shape[0], generator)
        return self.act_from_start(observation, z0, seed, generator, deterministic, num_steps)
