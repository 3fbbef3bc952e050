"""Diffusion active inference: belief sweep, refinement, policy, and the
terms of the training losses.

Counterpart of ``active_inference_diffusion_tpu/core/active_inference.py``
(``__init__`` :64-198, ``init_params`` :204-264, the model applications
and the posterior :270-425, ``generate_beliefs`` :431-570,
``compute_expected_free_energy`` :576-726, ``imagined_lambda_objective``
:733-889, ``elbo_terms`` and the loss assemblies :891-1073,
``refine_beliefs`` :1080-1121, ``act`` :1137-1208). The modules are
``nn.Module``s on an explicit device, CUDA unless the caller asks for
another. Every random draw is explicit: a call either takes a
``torch.Generator`` and draws, or takes the record of its draws
(``ActStart``, ``ElboDraws``, ``EfeDraws``, ``MineDraws``), so tests can
hand both packages the same numbers.

With ``act_from_posterior`` acting takes its belief from the amortised
posterior q(z | o) (one encoder pass) instead of the sweep; no sweep kernel
runs then.

The belief sweep goes through ``ops.denoise``: the variant
``tpu.denoiser_kernel`` selects ("v2", else v1) with the matmul weights in
the type ``tpu.compute_dtype`` selects ("bfloat16", else float32). On a
CUDA device it launches the variant's kernel where the kernels take the
width (``sweep_uses_kernel``: the JAX core's ``_use_fused_sweep`` rule, 48
MiB of trunk weights, decided once per core) and runs the plain sweep on
the card where they do not; on the CPU it runs the plain sweep, bfloat16
rounding included.
``tpu.use_pallas_denoiser`` chose between two TPU implementations and is
not read here.

``scan_beliefs`` is the sweep as the JAX core's ``lax.scan`` (its path
without the kernel): the score network's trunk and p_sample per step, plain
tensor ops under autograd, with every step's noise an explicit draw. It
serves ``generate_beliefs(return_trajectory=True)``, which JAX also never
gives to its kernel, and the train update's grounded beliefs
(``ground_beliefs``), whose gradient runs back through the whole chain. The
kernels have no backward pass (nor has the TPU kernel, which the JAX package
never differentiates), so on the card that sweep is the plain one, chosen
because a gradient is wanted and counted in ``PLAIN_RUNS``; acting keeps
the kernel. Branches this port does not have yet raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..configs.config import ActiveInferenceConfig
from ..models.decoders import (
    DECODER_DROPOUT,
    ContinuationPredictor,
    RewardPredictor,
    StateDecoder,
    reward_log_prob,
)
from ..models.dynamics import LatentDynamicsModel
from ..models.encoders import LatentPosteriorEncoder
from ..models.policy import DiffusionConditionedPolicy, PolicyDist, sample_action
from ..models.score_network import OBS_DROPOUT, LatentScoreNetwork
from ..models.value import ValueNetwork
from ..ops.denoise import (
    count_plain_run,
    fused_denoise_sweep,
    fused_denoise_sweep_v2,
    kernel_takes,
    packed_trunk_weights,
    plain_denoise_sweep,
)
from . import diffusion as dproc
from .belief_dynamics import FPConfig, fp_refine_mean
from .epistemic import FunctionSpaceEpistemicEstimator
from .returns import compute_lambda_returns
from .schedules import DiffusionSchedule, schedule_from_config
from .time_sampler import draw_time, importance_sample_time

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


# The JAX parameter groups and the module of the core each one fills.
GROUP_MODULES = {
    "score": "score_network",
    "diffusion": "diffusion",
    "policy": "policy_network",
    "value": "value_network",
    "dynamics": "latent_dynamics",
    "decoder": "observation_decoder",
    "reward": "reward_predictor",
    "continuation": "continuation_predictor",
    "epistemic": "epistemic_estimator",
    "posterior": "posterior_encoder",
}


def tree_to(obj, device):
    """A record of draws (nested NamedTuples and tuples of tensors, None
    allowed) with every tensor moved to ``device``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple):
        items = [tree_to(x, device) for x in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") else tuple(items)
    return obj


class BeliefInfo(NamedTuple):
    latent: torch.Tensor  # (B, D)
    latent_mean: torch.Tensor  # (D,)
    latent_std: torch.Tensor  # (D,)
    reconstruction_error: torch.Tensor  # scalar; 0 unless computed
    trajectory: Optional[torch.Tensor]  # (K+1, B, D) with return_trajectory, else None


class ActStart(NamedTuple):
    """The random draws of one act call that come before any model runs."""

    # (B, D) N(0, I): the sweep's start, a warm start's forward noise, or,
    # with act_from_posterior, the posterior sample's eps
    noise: torch.Tensor
    seed: torch.Tensor  # 0-d int64: the seed of the in-sweep noise
    refine_noise: Optional[torch.Tensor]  # (refine_steps, B, D) N(0, I); None without refinement

    def to(self, device) -> "ActStart":
        return tree_to(self, device)


class ElboDraws(NamedTuple):
    """The draws of one ``elbo_terms`` call in training."""

    decoder_masks: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # the decoder blocks' keep-masks
    score_mask: torch.Tensor  # (B, hidden) keep-mask of the score network's observation dropout
    time_bins: torch.Tensor  # (B,) int64 bins of the time importance sampler
    time_jitter: torch.Tensor  # (B,) uniform [0, 1) within the bin
    noise: torch.Tensor  # (B, D) N(0, I) of the forward diffusion
    prior_noise: torch.Tensor  # (B, D) N(0, I) of the latent prior sample


class EfeDraws(NamedTuple):
    """The draws of one imagined rollout: a ``compute_expected_free_energy``
    or an ``imagined_lambda_objective`` call."""

    policy_noise: torch.Tensor  # (horizon, T B, A) N(0, I) of the policy samples
    dynamics_noise: torch.Tensor  # (horizon, T B, D) N(0, I) of the imagined transitions
    # (horizon, T B) int64: the ensemble member of each imagined row and step;
    # None for one dynamics network
    members: Optional[torch.Tensor] = None

    def to(self, device) -> "EfeDraws":
        return tree_to(self, device)


class DiffusionActiveInference(nn.Module):
    """The models of one agent (score network, diffusion parameters, policy,
    value, dynamics, decoder, reward and continuation heads, the epistemic
    estimator, the posterior encoder) and the schedule."""

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
            raise NotImplementedError("pixel observations are not ported yet (ROADMAP A11)")
        if config.act_from_posterior and not config.posterior_beliefs:
            raise ValueError("act_from_posterior requires posterior_beliefs: without it the "
                             "posterior encoder gets no gradient")
        if config.posterior_beliefs and config.ground_beliefs:
            raise ValueError("posterior_beliefs and ground_beliefs are exclusive belief sources")
        if config.auto_entropy and not config.imagined_value_targets:
            raise ValueError("auto_entropy tunes the imagined actor's entropy coefficient and "
                             "needs imagined_value_targets")
        self.observation_dim = observation_dim
        self.action_dim = action_dim
        self.latent_dim = latent_dim
        self.config = config
        self.device = resolve_device(device)

        self.schedule: DiffusionSchedule = schedule_from_config(config.diffusion, self.device)
        h = config.hidden_dim
        self.score_network = LatentScoreNetwork(
            latent_dim=latent_dim,
            observation_dim=observation_dim,
            hidden_dim=h,
            num_layers=config.score_num_layers,
        )
        self.diffusion = dproc.DiffusionParams(latent_dim)
        # Explicit flag wins; otherwise corrected mode squashes.
        self.policy_squash = (
            config.policy_squash
            if config.policy_squash is not None
            else config.semantics.mode == "corrected"
        )
        self.policy_network = DiffusionConditionedPolicy(
            latent_dim=latent_dim, action_dim=action_dim, hidden_dim=h
        )
        self.value_network = ValueNetwork(latent_dim, hidden_dim=h, time_embed_dim=128,
                                          num_layers=3)
        self.latent_dynamics = LatentDynamicsModel(
            latent_dim, action_dim, hidden_dim=h, num_layers=3,
            members=config.num_dynamics_ensemble,
        )
        self.observation_decoder = StateDecoder(
            latent_dim=latent_dim, observation_dim=observation_dim, hidden_dim=h
        )
        self.reward_predictor = RewardPredictor(latent_dim, hidden_dim=h)
        self.continuation_predictor = ContinuationPredictor(latent_dim, hidden_dim=h)
        self.epistemic_estimator = FunctionSpaceEpistemicEstimator(
            observation_dim, latent_dim, ntk_samples=4,
            aggregator_output_dim=config.spatial_aggregator_output_dim,
        )
        self.posterior_encoder = LatentPosteriorEncoder(observation_dim, latent_dim, hidden_dim=h)
        # The kernels take the width, on a card: decided here, once.
        self.sweep_uses_kernel = self.device.type == "cuda" and kernel_takes(
            latent_dim, h, config.score_num_layers, self.sweep_dtype
        )
        self.to(self.device)

    # ------------------------------------------------------------------

    @property
    def sweep_variant(self) -> str:
        return "v2" if self.config.tpu.denoiser_kernel == "v2" else "v1"

    @property
    def sweep_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.config.tpu.compute_dtype == "bfloat16" else torch.float32

    def init_params(self, generator: torch.Generator) -> None:
        """Initialise every group with the Flax initialisers the JAX core's
        ``init_params`` uses; the numbers come from ``generator``."""
        for attr in GROUP_MODULES.values():
            getattr(self, attr).reset_parameters(generator)

    @contextlib.contextmanager
    def swapped(self, modules: Dict[str, nn.Module]) -> Iterator["DiffusionActiveInference"]:
        """The core with the named modules (``score_network``,
        ``policy_network``, ...) replaced for the duration of the block, as
        the JAX agent acts with substituted parameter groups."""
        saved = {name: self._modules[name] for name in modules}
        self._modules.update(modules)
        try:
            yield self
        finally:
            self._modules.update(saved)

    # -- model applications ----------------------------------------------

    def apply_policy(self, z: torch.Tensor,
                     params: Optional[Dict[str, torch.Tensor]] = None) -> PolicyDist:
        """The policy head; with ``params`` (a dict of its parameters by name,
        such as the EMA policy) in place of its own."""
        if params is None:
            return self.policy_network(z)
        return functional_call(self.policy_network, params, (z,))

    def apply_value(self, z: torch.Tensor, t: torch.Tensor,
                    params: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """V(z, t); with ``params`` (such as the slow critic) in place of
        the value network's own."""
        if params is None:
            return self.value_network(z, t)[..., 0]
        return functional_call(self.value_network, params, (z, t))[..., 0]

    def predict_next_latent_members(self, latent: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        """(K, B, D) next-latent means of all ensemble members."""
        return self.latent_dynamics(latent, action)

    def predict_next_latent(
        self, latent: torch.Tensor, action: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The members' mean next latent and the fixed log-variance
        ``dynamics_logvar``."""
        members = self.predict_next_latent_members(latent, action)
        next_mean = members[0] if members.shape[0] == 1 else members.mean(dim=0)
        return next_mean, torch.full_like(next_mean, self.config.dynamics_logvar)

    def imagine_next(
        self, latent: torch.Tensor, action: torch.Tensor, members: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One imagination step: the next-latent mean, its fixed log-variance
        and the model disagreement per row. With an ensemble, row i takes
        the mean of member ``members[i]`` (a uniform draw in [0, K)) and the
        disagreement is the members' standard deviation (ddof 0) averaged
        over latent dims; one network gives its mean and 0."""
        means = self.predict_next_latent_members(latent, action)
        if means.shape[0] > 1:
            if members is None:
                raise ValueError("imagination over an ensemble needs the member draws")
            rows = torch.arange(latent.shape[0], device=latent.device)
            next_mean = means[members, rows]
            disagreement = means.std(dim=0, correction=0).mean(dim=-1)
        else:
            next_mean = means[0]
            disagreement = torch.zeros_like(next_mean[:, 0])
        return next_mean, torch.full_like(next_mean, self.config.dynamics_logvar), disagreement

    def _imagined_transition(
        self, z: torch.Tensor, action: torch.Tensor, draws: "EfeDraws", i: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Step ``i`` of an imagined rollout: the next latent (the mean with
        ``imagine_deterministic``, else a sample at the fixed variance) and
        its guarded predicted reward."""
        members = None if draws.members is None else draws.members[i]
        next_mean, next_logvar, disagreement = self.imagine_next(z, action, members)
        if self.config.imagine_deterministic:
            next_z = next_mean
        else:
            next_z = next_mean + draws.dynamics_noise[i] * torch.exp(0.5 * next_logvar)
        reward_mean, reward_std = self.predict_reward(next_z)
        return next_z, self._guard_imagined_reward(reward_mean, reward_std, disagreement)

    def _guard_imagined_reward(
        self, reward_mean: torch.Tensor, reward_std: torch.Tensor, disagreement: torch.Tensor
    ) -> torch.Tensor:
        """NLL-sigma pessimism, ensemble-disagreement pessimism, then the
        hard clip, each where its weight is set."""
        cfg = self.config
        if cfg.imagined_reward_pessimism > 0.0:
            reward_mean = reward_mean - cfg.imagined_reward_pessimism * reward_std
        if cfg.ensemble_pessimism > 0.0:
            reward_mean = reward_mean - cfg.ensemble_pessimism * disagreement
        if cfg.imagined_reward_clip > 0.0:
            reward_mean = torch.clamp(
                reward_mean, -cfg.imagined_reward_clip, cfg.imagined_reward_clip
            )
        return reward_mean

    def predict_reward(self, latent: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.reward_predictor(latent)

    def predict_continuation(self, latent: torch.Tensor) -> torch.Tensor:
        """Continuation logit c(z); sigmoid gives P(episode continues)."""
        return self.continuation_predictor(latent)

    def decode_observation(
        self, latent: torch.Tensor, train: bool = False, dropout_masks=None
    ) -> torch.Tensor:
        """Decode a latent to observation space (the state branch)."""
        return self.observation_decoder(latent, train=train, dropout_masks=dropout_masks)

    def apply_posterior(self, observation: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The amortised posterior q(z | o): (mu, logstd)."""
        return self.posterior_encoder(observation)

    def sample_posterior(self, observation: torch.Tensor,
                         eps: Optional[torch.Tensor]) -> torch.Tensor:
        """The reparameterised draw mu + exp(logstd) eps; mu where ``eps`` is
        None (deterministic)."""
        mu, logstd = self.apply_posterior(observation)
        return mu if eps is None else mu + eps * torch.exp(logstd)

    def posterior_eps(self, noise: torch.Tensor) -> Optional[torch.Tensor]:
        """The eps of a posterior belief from a start's noise: None (the
        mean) with ``deterministic_beliefs``."""
        return None if self.config.deterministic_beliefs else noise

    def posterior_beliefs(self, observation: torch.Tensor, noise: torch.Tensor,
                          compute_reconstruction: bool = False) -> BeliefInfo:
        """The act path's belief with ``act_from_posterior``: a posterior
        sample (``posterior_eps`` of ``noise``), its batch mean and standard
        deviation (ddof 0, as the JAX act takes it) and, with
        ``compute_reconstruction``, the decoded sample's mean squared error
        against the observation."""
        latent = self.sample_posterior(observation, self.posterior_eps(noise))
        if compute_reconstruction:
            reconstruction_error = torch.mean((self.decode_observation(latent) - observation) ** 2)
        else:
            reconstruction_error = torch.zeros((), device=self.device)
        return BeliefInfo(latent=latent, latent_mean=latent.mean(dim=0),
                          latent_std=latent.std(dim=0, correction=0),
                          reconstruction_error=reconstruction_error, trajectory=None)

    # -- belief generation --------------------------------------------------

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

    def warm_start(self, noise: torch.Tensor, num_steps: int,
                   z_init: Optional[torch.Tensor]) -> torch.Tensor:
        """The sweep's start: ``noise``, or for a warm start ``z_init``
        forward-noised with it to the truncation timestep k-1."""
        if z_init is None:
            return noise
        t0 = torch.full((noise.shape[0],), num_steps - 1, dtype=torch.int64, device=self.device)
        return dproc.q_sample(self.schedule, z_init, t0, noise)

    @torch.no_grad()
    def beliefs_from_start(
        self,
        observation: torch.Tensor,
        noise: torch.Tensor,
        seed: torch.Tensor,
        num_steps: Optional[int] = None,
        deterministic: bool = False,
        z_init: Optional[torch.Tensor] = None,
        compute_reconstruction: bool = True,
    ) -> BeliefInfo:
        """The reverse-diffusion sweep conditioned on the observations. It
        starts from ``noise``, or, for a warm start, from ``z_init``
        forward-noised with ``noise`` to the truncation timestep k-1 by
        ``q_sample``. The observation embedding and all K time embeddings
        are computed once, outside the sweep. With
        ``compute_reconstruction`` the reconstruction error is the mean
        squared error of the decoded belief against the observation."""
        k = self.schedule.num_steps if num_steps is None else num_steps
        if k > self.schedule.num_steps:
            raise ValueError(f"num_steps={k} exceeds schedule length {self.schedule.num_steps}")
        z0 = self.warm_start(noise, k, z_init)

        net = self.score_network
        obs_emb = net.obs_embedding(observation)
        timesteps = torch.arange(k - 1, -1, -1, device=self.device)
        t_embs = net.time_embedding(timesteps.to(observation.dtype), continuous=False)
        if self.sweep_uses_kernel or self.device.type != "cuda":
            sweep = fused_denoise_sweep_v2 if self.sweep_variant == "v2" else fused_denoise_sweep
        else:
            sweep = plain_denoise_sweep
        latent = sweep(
            self.schedule, packed_trunk_weights(net, self.sweep_variant, self.sweep_dtype),
            z0.contiguous(), obs_emb.contiguous(), t_embs.contiguous(), seed,
            num_steps=k, num_layers=self.config.score_num_layers, deterministic=deterministic,
        )

        return self._belief_info(latent, observation, compute_reconstruction)

    def _belief_info(self, latent: torch.Tensor, observation: torch.Tensor,
                     compute_reconstruction: bool,
                     trajectory: Optional[torch.Tensor] = None) -> BeliefInfo:
        """The sweep's result with its batch mean and standard deviation
        (ddof 1, 0 for one row) and, with ``compute_reconstruction``, the
        decoded belief's mean squared error against the observation."""
        latent_mean = latent.mean(dim=0)
        if latent.shape[0] > 1:
            latent_std = latent.std(dim=0, correction=1)
        else:
            latent_std = torch.zeros_like(latent_mean)
        if compute_reconstruction:
            reconstruction_error = torch.mean((self.decode_observation(latent) - observation) ** 2)
        else:
            reconstruction_error = torch.zeros((), device=self.device)
        return BeliefInfo(
            latent=latent,
            latent_mean=latent_mean,
            latent_std=latent_std,
            reconstruction_error=reconstruction_error,
            trajectory=trajectory,
        )

    def scan_beliefs(
        self,
        observation: torch.Tensor,
        z0: torch.Tensor,
        step_noise: Optional[torch.Tensor],
        num_steps: Optional[int] = None,
        deterministic: bool = False,
        return_trajectory: bool = False,
    ) -> dproc.DenoiseResult:
        """The sweep as the JAX core's scan, from ``z0`` with the per-step
        standard normals ``step_noise`` (K, B, D) (None when
        ``deterministic``): the observation embedding and the K time
        embeddings once, then per step the score network's trunk on their
        sum and p_sample. Autograd follows it, so a loss on the latents
        reaches the score network through every step. On a CUDA device the
        run counts in ``PLAIN_RUNS``."""
        k = self.schedule.num_steps if num_steps is None else num_steps
        if k > self.schedule.num_steps:
            raise ValueError(f"num_steps={k} exceeds schedule length {self.schedule.num_steps}")
        net = self.score_network
        obs_emb = net.obs_embedding(observation)
        timesteps = torch.arange(k - 1, -1, -1, device=self.device)
        t_embs = net.time_embedding(timesteps.to(observation.dtype), continuous=False)
        result = dproc.reverse_sweep(
            self.schedule, lambda i, z: net.trunk(z, obs_emb + t_embs[i][None, :]), z0,
            step_noise, k, deterministic, return_trajectory,
        )
        count_plain_run(self.sweep_variant, self.sweep_dtype, self.device)
        return result

    def generate_beliefs(
        self,
        generator: torch.Generator,
        observation: torch.Tensor,
        num_steps: Optional[int] = None,
        deterministic: bool = False,
        return_trajectory: bool = False,
        compute_reconstruction: bool = True,
        z_init: Optional[torch.Tensor] = None,
    ) -> BeliefInfo:
        """Draw the start, then run ``beliefs_from_start``; with
        ``return_trajectory`` also draw every step's noise and run
        ``scan_beliefs``, whose trajectory (K+1, B, D) holds the start and
        each step's latents."""
        start = self.draw_start(observation.shape[0], generator)
        if not return_trajectory:
            return self.beliefs_from_start(
                observation, start.noise, start.seed, num_steps, deterministic, z_init,
                compute_reconstruction,
            )
        k = self.schedule.num_steps if num_steps is None else num_steps
        step_noise = torch.randn((k,) + tuple(start.noise.shape), generator=generator,
                                 device=self.device)
        with torch.no_grad():
            z0 = self.warm_start(start.noise, k, z_init)
            result = self.scan_beliefs(observation, z0, step_noise, k, deterministic,
                                       return_trajectory=True)
            return self._belief_info(result.latent, observation, compute_reconstruction,
                                     result.trajectory)

    # -- expected free energy ----------------------------------------------

    def draw_efe(self, batch_size: int, generator: torch.Generator) -> EfeDraws:
        """The draws of one imagined rollout from ``batch_size`` latents, in
        this order: the policy's noise, the transitions' noise and, with an
        ensemble, each row's member per step."""
        cfg = self.config
        n = cfg.num_efe_trajectories * batch_size
        dev = self.device
        policy = torch.randn((cfg.efe_horizon, n, self.action_dim), generator=generator, device=dev)
        dynamics = torch.randn((cfg.efe_horizon, n, self.latent_dim), generator=generator,
                               device=dev)
        members = None
        if cfg.num_dynamics_ensemble > 1:
            members = torch.randint(0, cfg.num_dynamics_ensemble, (cfg.efe_horizon, n),
                                    generator=generator, device=dev)
        return EfeDraws(policy, dynamics, members)

    def _check_rollout_draws(self, draws: EfeDraws, n: int) -> None:
        if draws.policy_noise.shape[:2] != (self.config.efe_horizon, n):
            raise ValueError(f"rollout draws of shape {tuple(draws.policy_noise.shape)} do not "
                             f"fit horizon {self.config.efe_horizon} x {n} imagined rows")

    def compute_expected_free_energy(
        self,
        latent: torch.Tensor,
        preference_temperature: torch.Tensor,
        draws: EfeDraws,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """G(pi) accumulated over imagined latent trajectories: the
        ``num_efe_trajectories`` copies of the batch are folded into one
        batch axis and rolled ``efe_horizon`` steps through the policy and
        the dynamics. A step's term is the signed pragmatic value
        (w_p r(z') / tau + w_v V(z', t)) plus ``consistency_weight`` times
        the negative policy entropy, discounted by gamma^t. Returns the EFE
        per batch row (B,) and the mean terms.

        The epistemic term has no policy gradient; corrected mode leaves it
        out here, as the JAX core does. Computing it (faithful mode) is not
        ported."""
        cfg = self.config
        if cfg.semantics.mode == "faithful" and cfg.epistemic_weight != 0.0:
            raise NotImplementedError(
                "the EFE's epistemic term (faithful semantics) is not ported yet (ROADMAP A4)"
            )
        horizon = cfg.efe_horizon
        batch_size = latent.shape[0]
        n = cfg.num_efe_trajectories * batch_size
        self._check_rollout_draws(draws, n)
        prag_w = cfg.pragmatic_weight
        prag_scale = cfg.semantics.pragmatic_sign * (
            prag_w if cfg.semantics.double_pragmatic_weight else 1.0
        )
        z = latent.repeat(cfg.num_efe_trajectories, 1)
        total = torch.zeros(n, dtype=latent.dtype, device=latent.device)
        prag_means, cons_means = [], []
        for i in range(horizon):
            dist = self.apply_policy(z)
            action, _ = sample_action(dist, draws.policy_noise[i], squash=self.policy_squash)
            next_z, reward_mean = self._imagined_transition(z, action, draws, i)
            t_batch = torch.full((n,), float(i), dtype=z.dtype, device=z.device)
            pragmatic = prag_w * (reward_mean / preference_temperature)
            pragmatic = pragmatic + cfg.efe_value_weight * self.apply_value(next_z, t_batch)
            consistency = -dist.entropy()
            step_efe = prag_scale * pragmatic + cfg.consistency_weight * consistency
            total = total + cfg.discount_factor**i * step_efe
            prag_means.append(pragmatic.mean())
            cons_means.append(consistency.mean())
            z = next_z
        efe = total.reshape(cfg.num_efe_trajectories, batch_size).mean(dim=0)
        info = {
            "efe/epistemic_mean": torch.zeros((), device=latent.device),
            "efe/pragmatic_mean": torch.stack(prag_means).mean(),
            "efe/consistency_mean": torch.stack(cons_means).mean(),
        }
        return efe, info

    # -- the imagined lambda objective ----------------------------------------

    def imagined_lambda_objective(
        self,
        latent: torch.Tensor,
        draws: EfeDraws,
        preference_temperature: torch.Tensor,
        value_params: Optional[Dict[str, torch.Tensor]] = None,
        return_scale: Optional[torch.Tensor] = None,
        entropy_scale: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
               Dict[str, torch.Tensor]]:
        """The Dreamer-style actor loss over an imagined rollout: the
        ``num_efe_trajectories`` copies of the batch rolled ``efe_horizon``
        steps through the policy and ``imagine_next``; guarded predicted
        rewards over the preference temperature; the discount weighted by
        the stop-gradient continuation probability when
        ``predict_continuation`` is set; the bootstrap V(z_{t+1}, t+1) from
        ``value_params`` (the slow critic) or the live critic; lambda-returns
        taken backward. The actor loss is -mean(returns / norm) - entropy
        scale x mean entropy, with norm = max(1, return_scale) under
        ``imagined_return_norm`` and the entropy scale ``entropy_scale``
        (exp(log_alpha) with ``auto_entropy``) or
        ``imagined_entropy_scale``, both without gradient. Returns the loss,
        the critic's stop-gradient (states (H, N, D), times (H, N), returns
        (H, N)), and the ``imagined/*`` metrics, among them the 5th-95th
        percentile range of the returns."""
        cfg = self.config
        horizon, num_traj = cfg.efe_horizon, cfg.num_efe_trajectories
        n = num_traj * latent.shape[0]
        self._check_rollout_draws(draws, n)
        z = latent.repeat(num_traj, 1)
        zs, rewards, entropies, conts = [], [], [], []
        for i in range(horizon):
            dist = self.apply_policy(z)
            action, _ = sample_action(dist, draws.policy_noise[i], squash=self.policy_squash)
            next_z, reward = self._imagined_transition(z, action, draws, i)
            if cfg.predict_continuation:
                cont = torch.sigmoid(self.predict_continuation(next_z)).detach()
            else:
                cont = torch.ones_like(reward)
            zs.append(z)
            rewards.append(reward)
            entropies.append(dist.entropy())
            conts.append(cont)
            z = next_z
        zs_all = torch.stack(zs)  # (H, N, D): z_0 .. z_{H-1}
        zs_next = torch.cat([zs_all[1:], z[None]], dim=0)
        t_idx = torch.arange(horizon, dtype=latent.dtype, device=latent.device)
        t_next = (t_idx + 1.0)[:, None].expand(horizon, n)
        values_next = self.apply_value(
            zs_next.reshape(horizon * n, -1), t_next.reshape(horizon * n), params=value_params
        ).reshape(horizon, n)
        rewards_all = torch.stack(rewards) / preference_temperature
        gamma, lam = cfg.discount_factor, cfg.lambda_return
        ret = values_next[-1]
        returns = []
        for i in reversed(range(horizon)):
            ret = rewards_all[i] + gamma * conts[i] * ((1.0 - lam) * values_next[i] + lam * ret)
            returns.append(ret)
        lambda_returns = torch.stack(returns[::-1])  # (H, N)
        targets = lambda_returns.detach()
        return_range = _percentile(targets, 95.0) - _percentile(targets, 5.0)
        if cfg.imagined_return_norm and return_scale is not None:
            norm = torch.clamp(return_scale.detach(), min=1.0)
        else:
            norm = torch.ones((), dtype=latent.dtype, device=latent.device)
        if entropy_scale is not None:
            ent_scale = entropy_scale.detach()
        else:
            ent_scale = torch.full((), cfg.imagined_entropy_scale, dtype=latent.dtype,
                                   device=latent.device)
        entropy = torch.stack(entropies)
        actor_loss = -torch.mean(lambda_returns / norm) - ent_scale * torch.mean(entropy)
        info = {
            "imagined/lambda_return_mean": targets.mean(),
            "imagined/reward_mean": rewards_all.detach().mean(),
            "imagined/entropy_mean": entropy.detach().mean(),
            "imagined/return_range": return_range,
            "imagined/return_norm": norm,
            "imagined/entropy_scale": ent_scale,
            "imagined/continuation_mean": torch.stack(conts).mean(),
        }
        imagined_t = t_idx[:, None].expand(horizon, n)
        return actor_loss, (zs_all.detach(), imagined_t, targets), info

    # -- the diffusion ELBO -------------------------------------------------

    def draw_elbo(
        self, batch_size: int, time_importance: torch.Tensor, generator: torch.Generator
    ) -> ElboDraws:
        def keep(width: int, rate: float) -> torch.Tensor:
            u = torch.rand((batch_size, width), generator=generator, device=self.device)
            return u >= rate

        decoder_masks = tuple(keep(w, DECODER_DROPOUT) for w in self.observation_decoder.widths)
        score_mask = keep(self.config.hidden_dim, OBS_DROPOUT)
        bins, jitter = draw_time(time_importance, batch_size, generator)
        shape = (batch_size, self.latent_dim)
        noise = torch.randn(shape, generator=generator, device=self.device)
        prior_noise = torch.randn(shape, generator=generator, device=self.device)
        return ElboDraws(decoder_masks, score_mask, bins, jitter, noise, prior_noise)

    def elbo_terms(
        self,
        observations: torch.Tensor,
        rewards: torch.Tensor,
        latents: torch.Tensor,
        draws: ElboDraws,
        train: bool = True,
    ) -> Dict[str, torch.Tensor]:
        """Every term of the diffusion ELBO, once; callers assemble the
        per-group losses. Reconstruction of the observation from the
        latents; score matching of the noised latents (as a fixed z_0
        draw) at importance-sampled continuous times against the true
        score; the gradient penalty ||d sum(score) / dz|| -> 1, a gradient
        of a gradient for the caller's backward; the KL to the learned
        prior, annealed by exp(-5 mean t); the reward NLL. Also the
        per-sample score losses and the times, for the importance sampler.
        Dropout runs where ``train``, with the draws' masks."""
        masks = draws.decoder_masks if train else None
        decoded = self.decode_observation(latents, train=train, dropout_masks=masks)
        reconstruction_loss = torch.mean((decoded - observations) ** 2)

        t = importance_sample_time(draws.time_bins, draws.time_jitter)
        noise = draws.noise
        noisy_latents, qinfo = dproc.continuous_q_sample(self.diffusion, latents.detach(), t, noise)
        score_mask = draws.score_mask if train else None

        def score_at(z: torch.Tensor) -> torch.Tensor:
            return self.score_network(z, t, observations, continuous=True,
                                      obs_dropout_mask=score_mask)

        predicted_score = score_at(noisy_latents)
        sigma = qinfo["sigma"]
        denom = torch.sqrt(sigma) if self.config.semantics.score_target_uses_std else sigma
        true_score = -noise / (denom + 1e-8)
        loss_weight = dproc.compute_loss_weight(self.diffusion, t)
        per_sample = loss_weight * torch.sum((predicted_score - true_score) ** 2, dim=1)
        score_matching_loss = torch.mean(per_sample)

        z = noisy_latents.detach().requires_grad_(True)
        (grads,) = torch.autograd.grad(score_at(z).sum(), z, create_graph=True)
        # epsilon inside the sqrt: the exact norm has a NaN gradient at 0
        grad_norm = torch.sqrt(torch.sum(grads**2, dim=1) + 1e-12)
        grad_penalty = torch.mean((grad_norm - 1.0) ** 2)

        prior_latents = dproc.sample_latent_prior(self.diffusion, draws.prior_noise)
        kl_loss = torch.mean(0.5 * torch.sum((latents - prior_latents) ** 2, dim=-1))
        kl_anneal = torch.exp(-5.0 * torch.mean(t))

        reward_mean, reward_std = self.predict_reward(latents)
        reward_loss = -torch.mean(reward_log_prob(reward_mean, reward_std, rewards))
        return {
            "reconstruction_loss": reconstruction_loss,
            "score_matching_loss": score_matching_loss,
            "per_sample_score_losses": per_sample,
            "grad_penalty": grad_penalty,
            "kl_loss": kl_loss,
            "kl_anneal": kl_anneal,
            "reward_loss": reward_loss,
            "t": t,
            "mean_time": torch.mean(t),
            "loss_weight_mean": torch.mean(loss_weight),
        }

    def assemble_score_loss(self, terms: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The score+diffusion group's loss: score matching, the annealed KL
        and the gradient penalty, minimised (corrected mode); faithful mode
        ascends them, as the reference's literal -elbo does."""
        cfg = self.config
        core = (
            cfg.diffusion_weight * terms["score_matching_loss"]
            + cfg.kl_weight * terms["kl_loss"] * terms["kl_anneal"]
            + cfg.grad_penalty_weight * terms["grad_penalty"]
        )
        return -core if cfg.semantics.mode == "faithful" else core

    def assemble_model_loss(
        self, terms: Dict[str, torch.Tensor], dynamics_loss: torch.Tensor
    ) -> torch.Tensor:
        """The model group's loss: reconstruction, weighted reward NLL and
        dynamics MSE (only the dynamics MSE where the semantics do not train
        the decoder and reward head)."""
        cfg = self.config
        if cfg.semantics.train_decoder_and_reward:
            return (
                terms["reconstruction_loss"]
                + cfg.reward_weight * terms["reward_loss"]
                + dynamics_loss
            )
        return dynamics_loss

    def elbo_value(self, terms: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The reference's reported ELBO scalar, for logging."""
        cfg = self.config
        return (
            -terms["reconstruction_loss"]
            + cfg.kl_weight * terms["kl_loss"] * terms["kl_anneal"]
            + cfg.diffusion_weight * terms["score_matching_loss"]
            + cfg.grad_penalty_weight * terms["grad_penalty"]
            - cfg.reward_weight * terms["reward_loss"]
        )

    def lambda_returns(
        self,
        rewards: torch.Tensor,
        values: torch.Tensor,
        next_values: torch.Tensor,
        dones: torch.Tensor,
    ) -> torch.Tensor:
        cfg = self.config
        return compute_lambda_returns(
            rewards, values, next_values, dones, discount=cfg.discount_factor,
            lambda_=cfg.lambda_return, n_steps=cfg.lambda_n_steps,
        )

    # -- acting ---------------------------------------------------------------

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
        if cfg.plan_candidates > 0:
            raise NotImplementedError(
                "act_planned (plan_candidates > 0) is not ported yet (ROADMAP A12)"
            )

    def _refined(self, latent: torch.Tensor, observation: torch.Tensor,
                 start: ActStart) -> torch.Tensor:
        if self.config.belief_dynamics.use_belief_dynamics:
            return self.refine_beliefs(latent, observation, noise=start.refine_noise)
        return latent

    def belief_latent(
        self,
        observation: torch.Tensor,
        start: ActStart,
        num_steps: Optional[int] = None,
        z_init: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """The act path's belief: the sweep (deterministic when
        ``deterministic_beliefs``), or with ``act_from_posterior`` a
        posterior sample (``z_init`` then plays no part), then, with
        ``use_belief_dynamics``, the Fokker-Planck refinement."""
        self.check_act_supported()
        if self.config.act_from_posterior:
            latent = self.posterior_beliefs(observation, start.noise).latent
        else:
            latent = self.beliefs_from_start(
                observation, start.noise, start.seed, num_steps,
                deterministic=self.config.deterministic_beliefs, z_init=z_init,
                compute_reconstruction=False,
            ).latent
        return self._refined(latent, observation, start)

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
        efe: Optional[EfeDraws] = None,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Everything of ``act`` after the start draw: the belief (sweep and
        refinement), the policy head and its sample. With the draws of an
        EFE (``compute_efe_info``) the info also holds the belief's
        reconstruction error and the EFE of the policy on the belief."""
        if efe is None:
            latent = self.belief_latent(observation, start, num_steps)
            return self.policy_action(latent, generator, deterministic)
        self.check_act_supported()
        if self.config.act_from_posterior:
            belief = self.posterior_beliefs(observation, start.noise, compute_reconstruction=True)
        else:
            belief = self.beliefs_from_start(
                observation, start.noise, start.seed, num_steps,
                deterministic=self.config.deterministic_beliefs,
            )
        latent = self._refined(belief.latent, observation, start)
        action, info = self.policy_action(latent, generator, deterministic)
        temperature = torch.tensor(self.config.preference_temperature, device=self.device)
        value, efe_info = self.compute_expected_free_energy(latent, temperature, efe)
        info["expected_free_energy"] = value.mean()
        info["reconstruction_error"] = belief.reconstruction_error
        info.update(efe_info)
        return action, info

    def act(
        self,
        generator: torch.Generator,
        observation: torch.Tensor,
        deterministic: bool = False,
        num_steps: Optional[int] = None,
        compute_efe_info: bool = False,
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Belief update via reverse diffusion, then a policy sample; with
        ``compute_efe_info`` also the EFE diagnostics (the reference computes
        them here but does not act on them)."""
        if observation.dim() == 1:
            observation = observation[None]
        start = self.draw_start(observation.shape[0], generator)
        efe = self.draw_efe(observation.shape[0], generator) if compute_efe_info else None
        return self.act_from_start(observation, start, generator, deterministic, num_steps, efe)


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q``-th percentile of all of ``x``, interpolated linearly
    between the two nearest ranks as ``jnp.percentile`` and
    ``torch.quantile`` take it. The ranks come from the shape alone, so a
    CUDA graph captures it (no read of the data on the host)."""
    ordered = x.flatten().sort().values
    pos = q / 100.0 * (ordered.numel() - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, ordered.numel() - 1)
    return ordered[lo] + (pos - lo) * (ordered[hi] - ordered[lo])
