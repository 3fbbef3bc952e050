"""Diffusion active inference, acting path: belief sweep, refinement, policy.

Counterpart of ``active_inference_diffusion_tpu/core/active_inference.py``
(``__init__`` :64-198, ``apply_policy`` :286-287, ``decode_observation``
:405-425, ``generate_beliefs`` :431-570, ``refine_beliefs`` :1080-1121,
``act`` :1137-1208). The modules are ``nn.Module``s on an explicit device,
CUDA unless the caller asks for another, and every draw takes an explicit
``torch.Generator``.

The belief sweep always goes through the fused sweep of ``ops.denoise``:
the variant ``tpu.denoiser_kernel`` selects ("v2", else v1) with the matmul
weights in the type ``tpu.compute_dtype`` selects ("bfloat16", else
float32). On a CUDA device that launches the variant's kernel; on the CPU
it runs the kernel's plain version, bfloat16 rounding included.
``tpu.use_pallas_denoiser`` chose between two TPU implementations and is
not read here. Branches this port does not have yet raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..configs.config import ActiveInferenceConfig
from ..models.decoders import StateDecoder
from ..models.policy import DiffusionConditionedPolicy, PolicyDist, sample_action
from ..models.score_network import LatentScoreNetwork
from ..ops.denoise import fused_denoise_sweep, fused_denoise_sweep_v2, packed_trunk_weights
from .belief_dynamics import FPConfig, fp_refine_mean
from .diffusion import q_sample
from .schedules import DiffusionSchedule, schedule_from_config

# The largest seed the sweep's noise generator is keyed with.
SEED_BOUND = 2**31 - 1


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None means CUDA, which must exist.
    The CPU runs only when the caller asks for it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; pass device='cpu' "
            "to run on the CPU"
        )
    return torch.device("cuda")


class BeliefInfo(NamedTuple):
    latent: torch.Tensor  # (B, D)
    latent_mean: torch.Tensor  # (D,)
    latent_std: torch.Tensor  # (D,)
    reconstruction_error: torch.Tensor  # scalar
    trajectory: Optional[torch.Tensor]  # always None in this port


class ActStart(NamedTuple):
    """The random draws of one act call that come before any model runs."""

    noise: torch.Tensor  # (B, D) N(0, I): the sweep's start, or a warm start's forward noise
    seed: torch.Tensor  # 0-d int64: the seed of the in-sweep noise
    refine_noise: Optional[torch.Tensor]  # (refine_steps, B, D) N(0, I); None without refinement

    def to(self, device) -> "ActStart":
        return ActStart(*(None if t is None else t.to(device) for t in self))


class DiffusionActiveInference(nn.Module):
    """Score network, policy, state decoder and schedule of one agent."""

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
        self.device = resolve_device(device)

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
        self.observation_decoder = StateDecoder(
            latent_dim=latent_dim, observation_dim=observation_dim, hidden_dim=config.hidden_dim
        )
        self.to(self.device)

    # ------------------------------------------------------------------

    @property
    def sweep_variant(self) -> str:
        return "v2" if self.config.tpu.denoiser_kernel == "v2" else "v1"

    @property
    def sweep_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.tpu.compute_dtype == "bfloat16" else torch.float32

    def apply_policy(self, z: torch.Tensor) -> PolicyDist:
        return self.policy_network(z)

    def decode_observation(self, latent: torch.Tensor, train: bool = False) -> torch.Tensor:
        """Decode a latent to observation space (the state branch)."""
        return self.observation_decoder(latent, train=train)

    def draw_start(self, batch_size: int, generator: torch.Generator) -> ActStart:
        """The draws of one act call, in this order: the sweep's start
        N(0, I) (B, D), the seed of its in-sweep noise, and, when belief
        refinement is on, its (refine_steps, B, D) standard normals."""
        noise = torch.randn(
            (batch_size, self.latent_dim), generator=generator, device=self.device
        )
        seed = torch.randint(
            0, SEED_BOUND, (), generator=generator, device=self.device, dtype=torch.int64
        )
        bd = self.config.belief_dynamics
        refine_noise = None
        if bd.use_belief_dynamics:
            refine_noise = torch.randn(
                (bd.refine_steps, batch_size, self.latent_dim),
                generator=generator, device=self.device,
            )
        return ActStart(noise, seed, refine_noise)

    @torch.no_grad()
    def beliefs_from_start(
        self,
        observation: torch.Tensor,
        noise: torch.Tensor,
        seed: torch.Tensor,
        num_steps: Optional[int] = None,
        deterministic: bool = False,
        z_init: Optional[torch.Tensor] = None,
    ) -> BeliefInfo:
        """The reverse-diffusion sweep conditioned on the observations. It
        starts from ``noise``, or, for a warm start, from ``z_init``
        forward-noised with ``noise`` to the truncation timestep k-1 by
        ``q_sample``. The observation embedding and all K time embeddings
        are computed once, outside the sweep."""
        k = self.schedule.num_steps if num_steps is None else num_steps
        if k > self.schedule.num_steps:
            raise ValueError(f"num_steps={k} exceeds schedule length {self.schedule.num_steps}")
        z0 = noise
        if z_init is not None:
            t0 = torch.full((noise.shape[0],), k - 1, dtype=torch.int64, device=self.device)
            z0 = q_sample(self.schedule, z_init, t0, noise)

        net = self.score_network
        obs_emb = net.obs_embedding(observation)
        timesteps = torch.arange(k - 1, -1, -1, device=self.device)
        t_embs = net.time_embedding(timesteps.to(observation.dtype), continuous=False)
        sweep = fused_denoise_sweep_v2 if self.sweep_variant == "v2" else fused_denoise_sweep
        latent = sweep(
            self.schedule, packed_trunk_weights(net, self.sweep_variant, self.sweep_dtype),
            z0.contiguous(), obs_emb.contiguous(), t_embs.contiguous(), seed,
            num_steps=k, num_layers=self.config.score_num_layers, deterministic=deterministic,
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
        z_init: Optional[torch.Tensor] = None,
    ) -> BeliefInfo:
        """Draw the start, then run ``beliefs_from_start``."""
        if return_trajectory:
            raise NotImplementedError("return_trajectory is not ported yet")
        start = self.draw_start(observation.shape[0], generator)
        return self.beliefs_from_start(
            observation, start.noise, start.seed, num_steps, deterministic, z_init
        )

    def refine_beliefs(
        self,
        latent: torch.Tensor,
        observation: torch.Tensor,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``refine_steps`` Fokker-Planck mean-drift steps on -grad F, with
        F(z) = ||decode(z) - o||^2 / (2 noise_scale^2) + ||z||^2 / 2."""
        bd = self.config.belief_dynamics
        inv_var = 1.0 / (bd.noise_scale**2)
        obs = observation.detach()

        def free_energy(z: torch.Tensor) -> torch.Tensor:
            flat = (self.decode_observation(z, train=False) - obs).reshape(z.shape[0], -1)
            return 0.5 * inv_var * torch.sum(flat**2, dim=-1) + 0.5 * torch.sum(z**2, dim=-1)

        return fp_refine_mean(
            latent, FPConfig.from_config(bd), free_energy, bd.refine_steps, generator, noise
        )

    def check_act_supported(self) -> None:
        """Raise for the acting branches this port does not have yet."""
        cfg = self.config
        if cfg.act_from_posterior:
            raise NotImplementedError("act_from_posterior is not ported yet")
        if cfg.plan_candidates > 0:
            raise NotImplementedError("act_planned (plan_candidates > 0) is not ported yet")

    def belief_latent(
        self,
        observation: torch.Tensor,
        start: ActStart,
        num_steps: Optional[int] = None,
        z_init: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The act path's belief: the sweep (deterministic when
        ``deterministic_beliefs``), then, with ``use_belief_dynamics``, the
        Fokker-Planck refinement."""
        self.check_act_supported()
        latent = self.beliefs_from_start(
            observation, start.noise, start.seed, num_steps,
            deterministic=self.config.deterministic_beliefs, z_init=z_init,
        ).latent
        if self.config.belief_dynamics.use_belief_dynamics:
            latent = self.refine_beliefs(latent, observation, noise=start.refine_noise)
        return latent

    @torch.no_grad()
    def policy_action(
        self,
        latent: torch.Tensor,
        generator: Optional[torch.Generator],
        deterministic: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The policy head on the belief and its sample; ``generator`` is
        drawn from only for a stochastic sample."""
        dist = self.apply_policy(latent)
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

    @torch.no_grad()
    def act_from_start(
        self,
        observation: torch.Tensor,
        start: ActStart,
        generator: Optional[torch.Generator],
        deterministic: bool = False,
        num_steps: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Everything of ``act`` after the start draw: the belief (sweep and
        refinement), the policy head and its sample."""
        latent = self.belief_latent(observation, start, num_steps)
        return self.policy_action(latent, generator, deterministic)

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
        start = self.draw_start(observation.shape[0], generator)
        return self.act_from_start(observation, start, generator, deterministic, num_steps)
