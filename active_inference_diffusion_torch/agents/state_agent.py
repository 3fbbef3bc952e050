"""State-observation agent: acting and the train update.

Counterpart of ``active_inference_diffusion_tpu/agents/state_agent.py``
(``_act_impl`` :74-118, ``_acting_params`` :120-132, ``_act_warm_impl`` /
``act_warm`` :141-217, ``act`` :219-243, ``train_step`` /
``_train_step_impl`` :249-709).

Acting takes the train state: with ``use_ema_for_act`` the score network's
EMA and with ``act_with_policy_ema`` the EMA policy act in place of the
live networks (``acting_modules``), as the JAX agent's ``_acting_params``
substitutes them.

One train update: reward normalisation; the beliefs of observations and
next observations together (2B rows): one sweep without gradient (the sweep
kernel on the card); or with ``ground_beliefs`` the sweep inside the fused
loss (``scan_beliefs``, the JAX core's scan), so the reconstruction, KL and
reward gradients reach the score network through the denoising chain; or
with ``posterior_beliefs`` a posterior sample inside the fused loss, so the
posterior encoder learns from the reconstruction, reward and KL terms; the
fused score+model loss (the ELBO terms, with the gradient penalty's
gradient of a gradient, the dynamics MSE and the continuation BCE on
stop-gradient latents) and its two AdamW updates; the score EMA and the
time-importance update; the actor (the EFE, or with
``imagined_value_targets`` the imagined lambda objective against the slow
critic), plus the policy anchor KL(pi || EMA pi) once
``policy_anchor_warmup_steps`` have passed, and its update; value
regression on replay lambda-returns, or on the imagined returns with the
slow-critic regulariser; every ``epistemic_update_every`` steps the MINE
update; then the slow critic, the return scale, log_alpha (with
``auto_entropy``) and the EMA policy. Which of the MINE update and the
anchor run is decided on the host step count (``update_kind``). Every draw
of the update is in a ``TrainDraws``. Faithful semantics raises
``NotImplementedError`` naming its ROADMAP item.

The grounded sweep is the plain sweep under autograd on every device, by
design: the sweep kernels have no backward pass, and the JAX package trains
this flag through its XLA scan too (``tpu.use_pallas_denoiser`` is off by
default and the kernel is never differentiated). On the card each such
sweep counts in ``PLAIN_RUNS``, apart from the kernel's ``LAUNCHES``; the
choice is made by the flag, never by a failed launch, and acting keeps
launching the kernel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.active_inference import ActStart, EfeDraws, ElboDraws, tree_to
from ..core.epistemic import MineDraws, draw_mine, estimate_epistemic_value
from ..core.time_sampler import update_time_importance
from ..models.ema import shadow_module, update_ema
from ..models.policy import gaussian_kl
from .base import AgentTrainState, BaseAgent

# MINE latent samples per transition in the train update (the JAX step's num_samples).
MINE_SAMPLES = 5


def _grads(loss: torch.Tensor, params):
    """d loss / d params; None where the loss does not reach a parameter."""
    return torch.autograd.grad(loss, params, allow_unused=True)


class _Phases:
    """Labels the phases of a train update for ``torch.profiler``
    (``train_step/<phase>`` ranges; a no-op cost when nothing profiles):
    each call closes the open range and opens the named one; None closes."""

    def __init__(self):
        self.open = None

    def __call__(self, name: Optional[str]) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
        self.open = None
        if name is not None:
            self.open = torch.profiler.record_function(f"train_step/{name}")
            self.open.__enter__()


class TrainDraws(NamedTuple):
    """Every random draw of one train update."""

    # (2B, D) N(0, I): the belief sweep's start, or with posterior_beliefs the
    # posterior sample's eps
    belief_noise: torch.Tensor
    belief_seed: torch.Tensor  # 0-d int64: the seed of the sweep's in-sweep noise
    elbo: ElboDraws
    efe: EfeDraws  # the actor's imagined rollout: the EFE's or the imagined objective's
    mine: Optional[MineDraws]  # None on a step without the MINE update
    # (K, 2B, D) N(0, I): the grounded sweep's per-step noise; None without
    # ground_beliefs or with deterministic beliefs
    sweep_noise: Optional[torch.Tensor] = None

    def to(self, device) -> "TrainDraws":
        return tree_to(self, device)


class DiffusionStateAgent(BaseAgent):
    """Agent over raw state observations."""

    # The optimizer partitions and the JAX parameter groups of each; the
    # posterior encoder gets a (zero) gradient unless posterior_beliefs
    # routes the training latents through it.
    PARTITIONS = {
        "score": ["score", "diffusion"],
        "policy": ["policy"],
        "value": ["value"],
        "model": ["dynamics", "decoder", "reward", "continuation", "posterior"],
        "epistemic": ["epistemic"],
    }

    # -- acting ---------------------------------------------------------

    def acting_modules(self, state: Optional[AgentTrainState]) -> Dict[str, nn.Module]:
        """The core's modules to act with in place of the live ones, by
        attribute: the score network's EMA with ``use_ema_for_act``, the
        EMA policy with ``act_with_policy_ema`` where ``state`` holds one.
        Each is a module whose parameters are the state's EMA tensors
        (``shadow_module``), kept while the state's EMA is the same. Raises
        where a flag is set and there is no state: acting never falls back
        to the live weights."""
        cfg = self.config
        wanted = {"score_network": ("use_ema_for_act", lambda s: s.ema_score),
                  "policy_network": ("act_with_policy_ema", lambda s: s.ema_policy)}
        modules = {}
        for attr, (flag, ema_of) in wanted.items():
            if not getattr(cfg, flag):
                continue
            if state is None:
                raise ValueError(f"{flag} is set: acting needs the train state, whose EMA it "
                                 "acts with")
            ema = ema_of(state)
            if ema is None:
                continue
            key = tuple(t.data_ptr() for t in ema.values())
            cached = self._shadows.get(attr)
            if cached is None or cached[0] != key:
                cached = (key, shadow_module(getattr(self.core, attr), ema))
                self._shadows[attr] = cached
            modules[attr] = cached[1]
        return modules

    def act(
        self,
        observation: np.ndarray,
        generator: torch.Generator,
        deterministic: bool = False,
        collect: bool = True,
        state: Optional[AgentTrainState] = None,
    ) -> np.ndarray:
        """Batched observations (N, obs_dim) -> actions (N, A) in [-1, 1].

        ``collect`` runs ``training_config.collect_diffusion_steps`` sweep
        steps (None = the full schedule); evaluation runs the full schedule.
        ``generator`` lives on the agent's device and feeds every draw.
        ``state`` is the train state whose EMAs act where the config says
        so (``acting_modules``)."""
        obs = torch.as_tensor(observation, dtype=torch.float32, device=self.device)
        if obs.dim() == 1:
            obs = obs[None]
        num_steps = self.training_config.collect_diffusion_steps if collect else None
        start = self.core.draw_start(obs.shape[0], generator)
        action, _ = self.act_from_start(obs, start, generator, deterministic, num_steps,
                                        state=state)
        return action.cpu().numpy()

    def act_warm(
        self,
        observation: np.ndarray,
        generator: torch.Generator,
        prev_latents: torch.Tensor,
        reset_mask: np.ndarray,
        deterministic: bool = False,
        num_steps: Optional[int] = None,
        state: Optional[AgentTrainState] = None,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Warm-start acting: each row's sweep starts from its previous
        belief (``prev_latents`` (N, D)), forward-noised to the truncation
        timestep, instead of pure noise; rows where ``reset_mask`` (N,) is
        True start from fresh N(0, I) latents. ``num_steps`` defaults to
        ``training_config.collect_diffusion_steps``. With
        ``act_from_posterior`` the belief is a posterior sample and the
        previous latents play no part. Returns the actions (N, A) and the
        belief latents (N, D) on the agent's device, to pass back as the
        next call's ``prev_latents``. ``state`` as for ``act``."""
        obs = torch.as_tensor(observation, dtype=torch.float32, device=self.device)
        mask = torch.as_tensor(np.asarray(reset_mask, bool), device=self.device)
        fresh = torch.randn(prev_latents.shape, generator=generator, device=self.device)
        start = self.core.draw_start(obs.shape[0], generator)
        if num_steps is None:
            num_steps = self.training_config.collect_diffusion_steps
        action, latent = self.act_warm_from_start(
            obs, prev_latents, mask, fresh, start, generator, deterministic, num_steps,
            state=state,
        )
        return action.cpu().numpy(), latent

    @torch.no_grad()
    def act_warm_from_start(
        self,
        observation: torch.Tensor,
        prev_latents: torch.Tensor,
        reset_mask: torch.Tensor,
        fresh: torch.Tensor,
        start: ActStart,
        generator: Optional[torch.Generator],
        deterministic: bool = False,
        num_steps: Optional[int] = None,
        state: Optional[AgentTrainState] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything of ``act_warm`` after its draws: ``fresh`` replaces
        the reset rows of ``prev_latents``, then ``act_from_start`` from
        there."""
        z_prev = torch.where(reset_mask[:, None], fresh, prev_latents.to(self.device))
        return self.act_from_start(
            observation, start, generator, deterministic, num_steps, z_init=z_prev, state=state
        )

    @torch.no_grad()
    def act_from_start(
        self,
        observation: torch.Tensor,
        start: ActStart,
        generator: Optional[torch.Generator],
        deterministic: bool = False,
        num_steps: Optional[int] = None,
        z_init: Optional[torch.Tensor] = None,
        state: Optional[AgentTrainState] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything of ``act`` after the start draws: the belief (sweep,
        from ``z_init`` when given, or posterior sample, and refinement),
        the policy, exploration noise (only when not deterministic) and the
        clip to [-1, 1], with the modules ``acting_modules(state)`` names.
        Returns (actions, belief latents)."""
        with self.core.swapped(self.acting_modules(state)):
            latent = self.core.belief_latent(observation, start, num_steps, z_init)
            action, _ = self.core.policy_action(latent, generator, deterministic)
        if not deterministic:
            noise = torch.randn(action.shape, generator=generator, device=self.device)
            action = action + noise * self.exploration_noise
        # Always clip to the action space, as the JAX agent does.
        return torch.clamp(action, -1.0, 1.0), latent

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def check_train_supported(self) -> None:
        """Raise for the training branches this port does not have yet."""
        cfg = self.config
        unported = {
            "faithful semantics": (cfg.semantics.mode == "faithful", "A4"),
        }
        for flag, (on, item) in unported.items():
            if on:
                raise NotImplementedError(f"training with {flag} is not ported yet (ROADMAP {item})")

    def update_kind(self, step: int) -> Tuple[bool, bool]:
        """What the update at ``step`` runs beyond the rest, decided on the
        host: (the MINE update, every ``epistemic_update_every`` steps; the
        policy anchor, from ``policy_anchor_warmup_steps`` on where its
        weight is set)."""
        cfg = self.config
        return (step % cfg.epistemic_update_every == 0,
                cfg.policy_anchor_weight > 0 and step >= cfg.policy_anchor_warmup_steps)

    def draw_train(self, state: AgentTrainState, batch_size: int) -> TrainDraws:
        """The draws of one update from ``state.rng``: the beliefs' (the
        sweep's start and seed, or the posterior's eps; with stochastic
        grounded beliefs also every step's noise), the ELBO's, the actor's
        rollout, and the MINE update's on a step that runs it."""
        core, g, dev = self.core, state.rng, self.device
        start = core.draw_start(2 * batch_size, g)
        sweep_noise = None
        if self.config.ground_beliefs and not self.config.deterministic_beliefs:
            sweep_noise = torch.randn((core.schedule.num_steps,) + tuple(start.noise.shape),
                                      generator=g, device=dev)
        elbo = core.draw_elbo(batch_size, state.time_importance, g)
        efe = core.draw_efe(batch_size, g)
        mine = None
        if self.update_kind(state.step)[0]:
            mine = draw_mine(batch_size, core.latent_dim, MINE_SAMPLES,
                             core.epistemic_estimator.ntk_samples, g, dev)
        return TrainDraws(start.noise, start.seed, elbo, efe, mine, sweep_noise)

    def train_step(
        self, state: AgentTrainState, batch: Dict[str, torch.Tensor]
    ) -> Tuple[AgentTrainState, Dict[str, torch.Tensor]]:
        """One update on ``batch`` (``observations`` (B, obs), ``actions``
        (B, A), ``rewards`` (B,), ``next_observations``, ``dones`` (B,), on
        the agent's device). Draws from ``state.rng``, then
        ``train_step_from_draws``."""
        draws = self.draw_train(state, batch["rewards"].shape[0])
        return self.train_step_from_draws(state, batch, draws)

    def train_step_from_draws(
        self, state: AgentTrainState, batch: Dict[str, torch.Tensor], draws: TrainDraws
    ) -> Tuple[AgentTrainState, Dict[str, torch.Tensor]]:
        """Everything of ``train_step`` after its draws. Updates the core's
        parameters and ``state`` in place and returns the state and the
        metrics (0-d tensors on the device; nothing waits for the card)."""
        self.check_train_supported()
        cfg, core = self.config, self.core
        opt = state.optimizers
        mine, anchored = self.update_kind(state.step)
        rewards, actions, dones = batch["rewards"], batch["actions"], batch["dones"]
        reward_norm = state.reward_norm.update(rewards)
        norm_rewards = reward_norm.normalize(rewards)
        obs = batch["observations"]
        both = torch.cat([obs, batch["next_observations"]], dim=0)

        # 1. The beliefs of observations and next observations: one sweep,
        # no gradient; or, inside the fused loss, the grounded sweep or
        # posterior samples.
        phase = _Phases()
        if cfg.posterior_beliefs:
            phase("score_model")
            posterior = core.sample_posterior(both, core.posterior_eps(draws.belief_noise))
            latents, next_latents = posterior.chunk(2, dim=0)
        elif cfg.ground_beliefs:
            phase("score_model")
            grounded = core.scan_beliefs(both, draws.belief_noise, draws.sweep_noise,
                                         deterministic=cfg.deterministic_beliefs)
            latents, next_latents = grounded.latent.chunk(2, dim=0)
        else:
            phase("beliefs")
            belief = core.beliefs_from_start(
                both, draws.belief_noise, draws.belief_seed,
                deterministic=cfg.deterministic_beliefs, compute_reconstruction=False,
            )
            latents, next_latents = belief.latent.chunk(2, dim=0)
            phase("score_model")

        # 2. The fused score+model loss; the groups' losses are block-diagonal.
        # Score matching, dynamics and continuation see stop-gradient latents.
        terms = core.elbo_terms(obs, norm_rewards, latents, draws.elbo, train=True)
        score_loss = core.assemble_score_loss(terms)
        latents, next_latents = latents.detach(), next_latents.detach()
        pred_members = core.predict_next_latent_members(latents, actions)
        dynamics_loss = torch.mean((pred_members - next_latents[None]) ** 2)
        cont_logit = core.predict_continuation(next_latents)
        continuation_loss = F.binary_cross_entropy_with_logits(
            cont_logit, 1.0 - dones.to(cont_logit.dtype)
        )
        model_loss = core.assemble_model_loss(terms, dynamics_loss) + continuation_loss
        n_score = len(opt["score"].params)
        grads = _grads(score_loss + model_loss, opt["score"].params + opt["model"].params)
        opt["score"].step(grads[:n_score])
        opt["model"].step(grads[n_score:])
        update_ema(state.ema_score, core.score_network, cfg.ema_decay)
        state.time_importance = update_time_importance(
            state.time_importance, terms["t"], terms["per_sample_score_losses"].detach()
        )
        metrics = {
            "reconstruction_loss": terms["reconstruction_loss"],
            "kl_loss": terms["kl_loss"],
            "score_matching_loss": terms["score_matching_loss"],
            "grad_penalty": terms["grad_penalty"],
            "reward_loss": terms["reward_loss"],
            "elbo": core.elbo_value(terms),
            "mean_time": terms["mean_time"],
            "loss_weight_mean": terms["loss_weight_mean"],
            "dynamics_loss": dynamics_loss,
            "continuation_loss": continuation_loss,
        }
        metrics = {k: v.detach() for k, v in metrics.items()}

        # 3. The actor on the updated model: the EFE, or the imagined lambda
        # objective against the slow critic with the state's return scale and
        # entropy coefficient from before this step; plus the policy anchor.
        phase("policy")
        imagination = None
        if cfg.imagined_value_targets:
            actor_loss, imagination, actor_info = core.imagined_lambda_objective(
                latents, draws.efe, state.preference_temperature,
                value_params=state.target_value, return_scale=state.return_scale,
                entropy_scale=torch.exp(state.log_alpha) if cfg.auto_entropy else None,
            )
        else:
            efe, actor_info = core.compute_expected_free_energy(
                latents, state.preference_temperature, draws.efe
            )
            actor_loss = efe.mean()
        anchor = self.policy_anchor(state, latents)
        policy_loss = actor_loss + cfg.policy_anchor_weight * anchor if anchored else actor_loss
        opt["policy"].step(_grads(policy_loss, opt["policy"].params))
        metrics["policy_loss"] = policy_loss.detach()
        metrics.update({k: v.detach() for k, v in actor_info.items()})
        metrics["policy_anchor_kl"] = anchor.detach()

        # 4. Value regression: on the imagined returns, anchored to the slow
        # critic's predictions; or on replay lambda-returns.
        phase("value")
        if imagination is not None:
            zs, ts, targets = imagination
            zs, ts, targets = zs.reshape(-1, zs.shape[-1]), ts.reshape(-1), targets.reshape(-1)
            with torch.no_grad():
                slow = core.apply_value(zs, ts, params=state.target_value)
            values = core.apply_value(zs, ts)
            value_loss = (F.huber_loss(values, targets, delta=1.0)
                          + cfg.value_ema_regularizer * F.huber_loss(values, slow, delta=1.0))
        else:
            b = latents.shape[0]
            t_now = torch.zeros(b, device=self.device)
            with torch.no_grad():
                next_values = core.apply_value(next_latents, torch.ones(b, device=self.device))
                cur_values = core.apply_value(latents, t_now)
                targets = core.lambda_returns(norm_rewards, cur_values, next_values, dones)
            value_loss = F.huber_loss(core.apply_value(latents, t_now), targets, delta=1.0)
        opt["value"].step(_grads(value_loss, opt["value"].params))
        metrics["value_loss"] = value_loss.detach()

        # 5. The MINE update every epistemic_update_every steps.
        phase("mine")
        if mine:
            if draws.mine is None:
                raise ValueError(f"step {state.step} runs the MINE update: its draws are missing")
            with torch.no_grad():
                next_mean, next_logvar = core.predict_next_latent(latents, actions)
            result = estimate_epistemic_value(
                core.epistemic_estimator,
                lambda z: core.decode_observation(z, train=False),
                next_mean, next_logvar, draws.mine, state.epistemic_running_mean,
            )
            opt["epistemic"].step(_grads(-result.mi_lower_bound, opt["epistemic"].params))
            state.epistemic_running_mean = result.running_mean
            metrics["epistemic_mi"] = result.mi_lower_bound.detach()
        else:
            metrics["epistemic_mi"] = torch.zeros((), device=self.device)

        # 6. The slow critic, the return scale and log_alpha (imagined actor
        # only), and the EMA policy, each from the networks as updated.
        phase("tail")
        with torch.no_grad():
            if cfg.imagined_value_targets:
                update_ema(state.target_value, core.value_network, cfg.target_value_decay)
                decay = cfg.return_norm_decay
                state.return_scale.copy_(decay * state.return_scale
                                         + (1.0 - decay) * actor_info["imagined/return_range"])
                if cfg.auto_entropy:
                    target = (cfg.entropy_target if cfg.entropy_target is not None
                              else -float(self.action_dim))
                    entropy = actor_info["imagined/entropy_mean"]
                    state.log_alpha.copy_(torch.clamp(
                        state.log_alpha - cfg.alpha_lr * (entropy - target), -13.8155, 2.3026))
            if state.ema_policy is not None:
                update_ema(state.ema_policy, core.policy_network, cfg.policy_ema_decay)

        phase(None)
        state.reward_norm = reward_norm
        state.step += 1
        return state, metrics

    def policy_anchor(self, state: AgentTrainState, latents: torch.Tensor) -> torch.Tensor:
        """Mean KL(pi_live || pi_EMA) on the (stop-gradient) replay latents;
        0 without an anchor weight or an EMA policy."""
        if self.config.policy_anchor_weight <= 0 or state.ema_policy is None:
            return torch.zeros((), device=self.device)
        live = self.core.apply_policy(latents)
        with torch.no_grad():
            ref = self.core.apply_policy(latents, params=state.ema_policy)
        return torch.mean(gaussian_kl(live, ref))
