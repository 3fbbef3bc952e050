"""Host-side agent shell, optimizer partitions, reward normalisation and the
train state.

Counterpart of ``active_inference_diffusion_tpu/agents/base.py``:
``RewardNormState`` (:26-57), ``AgentTrainState`` (:60-88),
``make_optimizers`` (:90-132), ``subset`` (:135) and ``BaseAgent``
(:145-276), with ``train_epoch`` (:180-237). The parameters live in the
core's modules, which the train step updates in place; the train state
holds everything else.

``train_epoch`` runs ``num_updates`` updates over a device replay ring
(``data/replay.py``) in near-equal chunks of at most
``TrainingConfig.epoch_chunk_updates`` (``epoch_chunks``, JAX's rule), each
update as JAX's scan body: a batch drawn from the ring, then the train
update. On a CUDA device each update is a replay of a captured CUDA graph
(``agents/graphs.py``), the counterpart of JAX's ``lax.scan`` over donated
state; on the CPU the same loop runs eagerly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from ..bridge import load_jax_params
from ..configs.config import ActiveInferenceConfig, TrainingConfig
from ..core.active_inference import GROUP_MODULES, DiffusionActiveInference
from ..core.time_sampler import init_time_importance
from ..data.replay import ReplayState, draw_indices, replay_sample
from ..models.ema import init_ema
from ..ops.denoise import forget_packed_trunks


@dataclass
class RewardNormState:
    """Welford-merged running mean and (population) variance of rewards, as
    0-d float32 tensors."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def create(cls, device=None, epsilon: float = 1e-4) -> "RewardNormState":
        def scalar(v):
            return torch.tensor(v, dtype=torch.float32, device=device)

        return cls(mean=scalar(0.0), var=scalar(1.0), count=scalar(epsilon))

    def update(self, x: torch.Tensor) -> "RewardNormState":
        batch_mean = torch.mean(x)
        batch_var = torch.var(x, correction=0)
        batch_count = float(x.shape[0])
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m2 = self.var * self.count + batch_var * batch_count + delta**2 * self.count * batch_count / tot
        return RewardNormState(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / torch.sqrt(self.var + 1e-8)


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's rule: gradients whose global norm reaches ``max_norm`` are
    scaled by max_norm / norm; others pass unchanged (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``). Multi-tensor kernels, no host
    sync."""
    grads = list(grads)
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    return list(torch._foreach_mul(grads, scale))


class PartitionOptimizer:
    """``optax.chain(clip_by_global_norm(clip), adamw(lr, weight_decay))``
    over one partition's parameters. AdamW is ``torch.optim.AdamW``, which
    takes optax's rule: eps outside the square root, no eps_root, the
    decoupled decay lr * wd * p taken with the update. ``schedule`` (a
    ``CosineDecay`` of the update count) replaces the constant rate, as
    optax evaluates it on the optimizer's own count. On a CUDA device AdamW
    is ``capturable`` (its step counts on the device), so an update can be
    captured in a CUDA graph; its moments and counts are made here, before
    any capture, so they never live in a graph's memory pool. A scheduled
    rate is a 0-d tensor on the parameters' device (``lr``) that each step
    writes in place from AdamW's own count, so a captured update decays it
    with no host write and the eager loop takes the same numbers."""

    def __init__(self, params: Sequence[nn.Parameter], lr: float, weight_decay: float,
                 clip: float, schedule: Optional["CosineDecay"] = None):
        self.params = list(params)
        self.clip = clip
        self.schedule = schedule
        self.count = 0
        capturable = bool(self.params) and self.params[0].is_cuda
        self.lr: Optional[torch.Tensor] = None
        if schedule is not None:
            self.lr = torch.tensor(lr, dtype=torch.float32, device=self.params[0].device)
        self.adamw = torch.optim.AdamW(
            self.params, lr=lr if self.lr is None else self.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay, capturable=capturable,
        )
        for p in self.params:  # AdamW's own lazy initial state, made now
            self.adamw.state[p] = {
                "step": torch.zeros((), device=p.device if capturable else "cpu"),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }

    def step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """One update from the partition's gradients (None for a parameter
        the loss does not reach: a zero gradient, as JAX gives)."""
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(self.params, grads)]
        for p, g in zip(self.params, clip_by_global_norm(grads, self.clip)):
            p.grad = g
        if self.lr is not None:  # of the count before this update
            self.lr.copy_(self.schedule(self.adamw.state[self.params[0]]["step"]))
        self.adamw.step()
        self.adamw.zero_grad(set_to_none=True)
        self.count += 1


class CosineDecay:
    """optax's ``cosine_decay_schedule``: init_value ((1 - alpha) (1 +
    cos(pi min(count, decay_steps) / decay_steps)) / 2 + alpha) of a count
    tensor, in float32 as optax takes it."""

    def __init__(self, init_value: float, decay_steps: int, alpha: float):
        self.init_value, self.decay_steps, self.alpha = init_value, decay_steps, alpha

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        frac = torch.clamp(count.to(torch.float32), max=self.decay_steps) / self.decay_steps
        cosine = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return self.init_value * ((1.0 - self.alpha) * cosine + self.alpha)


def epoch_chunks(num_updates: int, max_chunk: int) -> List[int]:
    """The JAX ``train_epoch``'s chunks: near-equal sizes of at most
    ``max_chunk`` (0: one chunk), the chunks one update larger first."""
    if num_updates < 1:
        raise ValueError(f"an epoch needs at least one update, got {num_updates}")
    if not max_chunk or num_updates <= max_chunk:
        return [num_updates]
    n_chunks = -(-num_updates // max_chunk)
    base = num_updates // n_chunks
    rem = num_updates - base * n_chunks
    return [base + 1] * rem + [base] * (n_chunks - rem)


def subset(core: DiffusionActiveInference, groups: Sequence[str]) -> List[nn.Parameter]:
    """The parameters of ``groups`` (JAX group names), group by group."""
    return [p for g in groups for p in getattr(core, GROUP_MODULES[g]).parameters()]


def make_optimizers(
    config: ActiveInferenceConfig, partitions: Mapping[str, List[str]],
    core: DiffusionActiveInference,
) -> Dict[str, PartitionOptimizer]:
    """One optimizer per partition, each clipped by its own global norm:
    weight decay 1e-5 for score, policy and epistemic, 0 for the others;
    the epistemic rate is a tenth; the policy's is scaled by
    ``policy_lr_scale`` and, with ``policy_lr_decay_steps``, decays along a
    cosine."""
    lr, clip = config.learning_rate, config.gradient_clip
    opts = {}
    for name, groups in partitions.items():
        params = subset(core, groups)
        if name == "score":
            opts[name] = PartitionOptimizer(params, lr, 1e-5, clip)
        elif name == "policy":
            plr = lr * config.policy_lr_scale
            schedule = None
            if config.policy_lr_decay_steps:
                schedule = CosineDecay(
                    plr, config.policy_lr_decay_steps, config.policy_lr_final_scale
                )
            opts[name] = PartitionOptimizer(params, plr, 1e-5, clip, schedule)
        elif name == "epistemic":
            opts[name] = PartitionOptimizer(params, lr * 0.1, 1e-5, clip)
        else:  # value, model
            opts[name] = PartitionOptimizer(params, lr, 0.0, clip)
    return opts


@dataclass
class AgentTrainState:
    """All training state but the parameters (which the core's modules
    hold): the host step count, the optimizers with their moments, the EMA
    shadow of the score network, the slow critic (the value network's EMA,
    the imagined actor's bootstrap), the imagined returns' scale and the log
    entropy coefficient, the time-importance weights, the MINE running mean,
    the reward normaliser, the preference temperature, the generator every
    draw of a step comes from, and the EMA policy (present only with the
    policy anchor or ``act_with_policy_ema``). The EMAs are dicts of tensors
    by parameter name, updated in place."""

    step: int
    optimizers: Dict[str, PartitionOptimizer]
    ema_score: Dict[str, torch.Tensor]
    target_value: Dict[str, torch.Tensor]
    return_scale: torch.Tensor  # 0-d, starts at 1
    log_alpha: torch.Tensor  # 0-d, starts at log imagined_entropy_scale
    time_importance: torch.Tensor  # (100,)
    epistemic_running_mean: torch.Tensor  # 0-d
    reward_norm: RewardNormState
    preference_temperature: torch.Tensor  # 0-d
    rng: torch.Generator
    ema_policy: Optional[Dict[str, torch.Tensor]] = None


class BaseAgent:
    """Holds the configs, the model container and the exploration noise scale.
    ``device`` None means CUDA, and raises where there is none."""

    # Parameter groups per optimizer; subclasses override.
    PARTITIONS: Dict[str, List[str]] = {}

    def __init__(
        self,
        observation_dim: int,
        action_dim: int,
        config: ActiveInferenceConfig,
        training_config: TrainingConfig,
        device: Optional[torch.device] = None,
    ):
        self.config = config
        self.training_config = training_config
        self.observation_dim = observation_dim
        self.action_dim = action_dim
        self.core = DiffusionActiveInference(
            observation_dim=observation_dim,
            action_dim=action_dim,
            latent_dim=config.latent_dim,
            config=config,
            device=device,
        )
        self.device = self.core.device
        self.exploration_noise = training_config.exploration_noise
        self.total_steps = 0
        self._epoch_graphs = None  # agents/graphs.py's EpochGraphs, made on the first CUDA epoch
        # attribute -> (the EMA's storage pointers, the module acting with it)
        self._shadows: Dict[str, Tuple[tuple, nn.Module]] = {}

    def load_jax_params(self, params: Mapping) -> Tuple[str, ...]:
        """Load the JAX agent's parameters (``params`` as a nested dict of
        numpy arrays): the acting groups, which must be there, and the
        other ported groups that are. Returns the groups it leaves for later
        ports."""
        return load_jax_params(self.core, params)

    def new_train_state(self, seed: int) -> AgentTrainState:
        """A train state over the current parameters, as the JAX
        ``init_train_state`` makes it: fresh optimizers (zero moments), the
        score EMA and the slow critic copies of their networks, return scale
        1, log_alpha log ``imagined_entropy_scale``, uniform time
        importance, the EMA policy a copy of the policy where the anchor or
        ``act_with_policy_ema`` needs it, and ``rng`` a generator on the
        agent's device seeded with ``seed``."""
        cfg, dev = self.config, self.device
        ema_policy = None
        if cfg.policy_anchor_weight > 0 or cfg.act_with_policy_ema:
            ema_policy = init_ema(self.core.policy_network)
        return AgentTrainState(
            step=0,
            optimizers=make_optimizers(cfg, self.PARTITIONS, self.core),
            ema_score=init_ema(self.core.score_network),
            target_value=init_ema(self.core.value_network),
            return_scale=torch.ones((), device=dev),
            log_alpha=torch.log(torch.tensor(cfg.imagined_entropy_scale, device=dev)),
            time_importance=init_time_importance(dev),
            epistemic_running_mean=torch.zeros((), device=dev),
            reward_norm=RewardNormState.create(dev),
            preference_temperature=torch.tensor(cfg.preference_temperature, device=dev),
            rng=torch.Generator(device=dev).manual_seed(seed),
            ema_policy=ema_policy,
        )

    def init_train_state(self, seed: int) -> AgentTrainState:
        """Initialise every parameter group as the JAX agent does (the Flax
        initialisers, torch's numbers), then ``new_train_state``."""
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.core.init_params(generator)
        return self.new_train_state(seed + 1)

    # -- the epoch ------------------------------------------------------

    def draw_update(self, state: AgentTrainState, replay_state: ReplayState, batch_size: int):
        """The draws of one update from ``state.rng``, in the JAX scan
        body's order: the batch's ring indices, then the train update's
        draws. Returns (indices, draws)."""
        indices = draw_indices(replay_state, batch_size, state.rng)
        return indices, self.draw_train(state, batch_size)

    def train_epoch(
        self, state: AgentTrainState, replay_state: ReplayState, num_updates: int
    ) -> Tuple[AgentTrainState, Dict[str, torch.Tensor]]:
        """``num_updates`` updates (a batch of ``config.batch_size`` drawn
        from ``replay_state``, then ``train_step_from_draws``), in the JAX
        ``train_epoch``'s chunks (``epoch_chunks``). Returns the state and
        every metric's mean over the updates (chunk means weighted by their
        sizes, as JAX takes them), 0-d tensors on the device; nothing waits
        for the card. On a CUDA device each update replays a captured CUDA
        graph (``agents/graphs.py``; a capture that fails raises), and the
        cached weight packs are dropped at the end, since replays move the
        weights without their version counters (the EMA modules' acting packs
        too). On the CPU the loop runs eagerly."""
        batch_size = self.config.batch_size
        graphs = None
        if self.device.type == "cuda":
            from .graphs import EpochGraphs

            if self._epoch_graphs is None:
                self._epoch_graphs = EpochGraphs(self)
            graphs = self._epoch_graphs
        total: Optional[Dict[str, torch.Tensor]] = None
        try:
            for size in epoch_chunks(num_updates, self.training_config.epoch_chunk_updates):
                if graphs is not None:
                    sums = graphs.run(state, replay_state, batch_size, size)
                else:
                    sums = None
                    for _ in range(size):
                        indices, draws = self.draw_update(state, replay_state, batch_size)
                        state, metrics = self.train_step_from_draws(
                            state, replay_sample(replay_state, indices), draws
                        )
                        if sums is None:
                            sums = {k: torch.zeros_like(v) for k, v in metrics.items()}
                        sums = {k: sums[k] + metrics[k] for k in sums}
                weighted = {k: v / size * size for k, v in sums.items()}
                total = weighted if total is None else {k: total[k] + weighted[k] for k in total}
        finally:
            if graphs is not None:
                forget_packed_trunks(self.core.score_network)
                for _, module in self._shadows.values():
                    forget_packed_trunks(module)
        self.total_steps += num_updates
        return state, {k: v / num_updates for k, v in total.items()}
