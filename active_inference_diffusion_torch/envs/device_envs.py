"""On-device environments and the fused rollout path.

Counterpart of ``active_inference_diffusion_tpu/envs/jax_envs.py``:
``EnvState`` and the env base class with ``scale_action``, ``reset``,
``step`` and ``step_autoreset`` (:26-94), ``Pendulum``, ``PointMass2D`` and
``Reacher2Link`` (:97-255), the registry (:258-300), ``Transitions``,
``fused_collect_stateful``, ``fused_collect`` and ``fused_eval``
(:303-441), ``add_action_noise``, ``with_exploration_noise`` and
``flatten_transitions`` (:444-495), and the rollout policies
``_policy_head``, ``make_rollout_policy``, ``make_warm_rollout_policy`` and
``init_warm_state`` (:498-598).

Every env is batched: an ``EnvState`` holds (N, ...) tensors, one row an
env. There is no per-env key. Every draw is explicit: a reset takes a
``ResetDraws`` (unit-uniform numbers and standard normals, laid out per
env class), a policy takes the draws its ``draw`` makes, and the fused
loops take the draws of every step (``CollectDraws``, ``EvalDraws``), so the
CPU tests hand both packages the same numbers. ``draw_collect`` and
``draw_eval`` make them from a ``torch.Generator`` in a fixed order.

The functions here run eagerly on any device. On the card the collect and
the eval replay one captured env step per step (``envs/collect_graph.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from ..core.active_inference import resolve_device
from ..models.policy import sample_action
from .mujoco_tasks import uniform_between


@dataclasses.dataclass
class EnvState:
    """A batch of envs: every field has a leading env axis."""

    physics: torch.Tensor  # (N, P) the env's physical state
    obs: torch.Tensor  # (N, obs_dim)
    reward: torch.Tensor  # (N,)
    done: torch.Tensor  # (N,) bool: terminated or truncated
    step_count: torch.Tensor  # (N,) int32
    # True only for a real MDP termination, False at a pure time limit: what
    # the replay ring stores, so the value bootstrap and the continuation
    # head see time-limit states as continuing. The analytic envs never
    # terminate.
    terminated: torch.Tensor  # (N,) bool

    def tensors(self) -> List[torch.Tensor]:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


class ResetDraws(NamedTuple):
    """The draws of a reset: unit-uniform numbers (N, k) and, for envs with
    a normal velocity noise, standard normals (N, m)."""

    uniform: torch.Tensor
    normal: Optional[torch.Tensor] = None


class DeviceEnv:
    """A batched env spec; ``reset`` and ``step`` are functions of tensors.
    ``device`` None means CUDA, which must exist."""

    observation_dim: int
    action_dim: int
    max_episode_steps: int = 1000
    action_low: Any = -1.0  # a float, or a (A,) tensor for per-dimension bounds
    action_high: Any = 1.0
    # the reset's unit-uniform numbers and standard normals per env
    reset_uniforms: int = 0
    reset_normals: int = 0

    def __init__(self, device=None, dtype: torch.dtype = torch.float32):
        self.device = resolve_device(device)
        self.dtype = dtype

    def _bounds(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The action bounds as float32 tensors on the env's device, made
        once (a captured step must not copy them from the host)."""
        cached = self.__dict__.get("_bound_tensors")
        if cached is None:
            cached = tuple(torch.as_tensor(b, dtype=torch.float32).to(self.device)
                           for b in (self.action_low, self.action_high))
            self._bound_tensors = cached
        return cached

    def scale_action(self, action: torch.Tensor) -> torch.Tensor:
        """Affine map of a normalised action in [-1, 1] to the env's action
        space (per-dimension and asymmetric bounds); for symmetric bounds
        exactly ``action * action_high``."""
        low, high = self._bounds()
        return low + (action + 1.0) * 0.5 * (high - low)

    def draw_reset(self, num_envs: int, generator: torch.Generator) -> ResetDraws:
        """The draws of ``reset`` for ``num_envs`` envs, in this order: the
        unit-uniform numbers, then the standard normals."""
        uniform = torch.rand((num_envs, self.reset_uniforms), generator=generator,
                             device=self.device, dtype=self.dtype)
        normal = None
        if self.reset_normals:
            normal = torch.randn((num_envs, self.reset_normals), generator=generator,
                                 device=self.device, dtype=self.dtype)
        return ResetDraws(uniform, normal)

    def _fresh(self, physics: torch.Tensor, obs: torch.Tensor) -> EnvState:
        n, dev = physics.shape[0], physics.device
        return EnvState(
            physics=physics, obs=obs,
            reward=torch.zeros(n, dtype=self.dtype, device=dev),
            done=torch.zeros(n, dtype=torch.bool, device=dev),
            step_count=torch.zeros(n, dtype=torch.int32, device=dev),
            terminated=torch.zeros(n, dtype=torch.bool, device=dev),
        )

    def reset(self, draws: ResetDraws) -> EnvState:
        raise NotImplementedError

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        raise NotImplementedError

    def step_autoreset(
        self, state: EnvState, action: torch.Tensor, reset: ResetDraws
    ) -> Tuple[EnvState, torch.Tensor]:
        """Step; where an episode ended, start a fresh one from ``reset``.

        Returns ``(state, true_next_obs)``: the carried state holds the
        fresh episode's first observation where done, but the transition's
        next observation is the true successor. The finishing step's
        reward, done and terminated are kept."""
        next_state = self.step(state, action)
        fresh = self.reset(reset)
        done = next_state.done

        def merge(a, b):
            return torch.where(done.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        merged = next_state.replace(
            physics=merge(fresh.physics, next_state.physics),
            obs=merge(fresh.obs, next_state.obs),
            step_count=merge(fresh.step_count, next_state.step_count),
        )
        return merged, next_state.obs

    def _time_limit(self, state: EnvState) -> Tuple[torch.Tensor, torch.Tensor]:
        step_count = state.step_count + 1
        return step_count, step_count >= self.max_episode_steps


class Pendulum(DeviceEnv):
    """Gymnasium Pendulum-v1 dynamics (JAX ``Pendulum``)."""

    observation_dim = 3
    action_dim = 1
    max_episode_steps = 200
    action_low = -2.0
    action_high = 2.0
    reset_uniforms = 2  # theta in [-pi, pi), thetadot in [-1, 1)

    max_speed = 8.0
    max_torque = 2.0
    dt = 0.05
    g = 10.0
    m = 1.0
    length = 1.0

    def _obs(self, theta, thetadot):
        return torch.stack([torch.cos(theta), torch.sin(theta), thetadot], dim=1)

    def reset(self, draws: ResetDraws) -> EnvState:
        u = draws.uniform.to(self.dtype)
        physics = torch.stack([uniform_between(u[:, 0], -math.pi, math.pi),
                               uniform_between(u[:, 1], -1.0, 1.0)], dim=1)
        return self._fresh(physics, self._obs(physics[:, 0], physics[:, 1]))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        theta, thetadot = state.physics[:, 0], state.physics[:, 1]
        u = torch.clamp(action[:, 0].to(self.dtype), -self.max_torque, self.max_torque)
        # floor modulo (jnp's %): torch.remainder, not fmod
        angle_norm = torch.remainder(theta + math.pi, 2 * math.pi) - math.pi
        costs = angle_norm**2 + 0.1 * thetadot**2 + 0.001 * u**2
        newthetadot = thetadot + (
            3.0 * self.g / (2.0 * self.length) * torch.sin(theta)
            + 3.0 / (self.m * self.length**2) * u
        ) * self.dt
        newthetadot = torch.clamp(newthetadot, -self.max_speed, self.max_speed)
        newtheta = theta + newthetadot * self.dt
        step_count, done = self._time_limit(state)
        return state.replace(
            physics=torch.stack([newtheta, newthetadot], dim=1),
            obs=self._obs(newtheta, newthetadot), reward=-costs, done=done,
            step_count=step_count,
        )


class PointMass2D(DeviceEnv):
    """Force-controlled point mass; reward = -distance to target - ctrl cost."""

    observation_dim = 6  # pos(2) vel(2) target(2)
    action_dim = 2
    max_episode_steps = 200
    reset_uniforms = 4  # pos(2), target(2), each in [-1, 1)
    dt = 0.05
    damping = 0.95

    def reset(self, draws: ResetDraws) -> EnvState:
        u = draws.uniform.to(self.dtype)
        pos = uniform_between(u[:, 0:2], -1.0, 1.0)
        target = uniform_between(u[:, 2:4], -1.0, 1.0)
        physics = torch.cat([pos, torch.zeros_like(pos), target], dim=1)
        return self._fresh(physics, physics)

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        phys = state.physics
        pos, vel, target = phys[:, :2], phys[:, 2:4], phys[:, 4:6]
        force = torch.clamp(action.to(self.dtype), -1.0, 1.0)
        vel = self.damping * vel + force * self.dt
        pos = torch.clamp(pos + vel * self.dt, -2.0, 2.0)
        dist = torch.sqrt(torch.sum((pos - target) ** 2, dim=1) + 1e-12)
        reward = -dist - 0.01 * torch.sum(force**2, dim=1)
        step_count, done = self._time_limit(state)
        physics = torch.cat([pos, vel, target], dim=1)
        return state.replace(physics=physics, obs=physics, reward=reward, done=done,
                             step_count=step_count)


class Reacher2Link(DeviceEnv):
    """Torque-controlled planar 2-link arm reaching a random target;
    obs = [cos q, sin q, qdot, target]."""

    observation_dim = 8
    action_dim = 2
    max_episode_steps = 200
    reset_uniforms = 4  # q(2) in [-pi, pi), target(2) in [-0.8, 0.8)
    dt = 0.05
    damping = 0.9

    def _obs(self, q, qdot, target):
        return torch.cat([torch.cos(q), torch.sin(q), qdot, target], dim=1)

    def _fingertip(self, q):
        x = torch.cos(q[:, 0]) * 0.5 + torch.cos(q[:, 0] + q[:, 1]) * 0.5
        y = torch.sin(q[:, 0]) * 0.5 + torch.sin(q[:, 0] + q[:, 1]) * 0.5
        return torch.stack([x, y], dim=1)

    def reset(self, draws: ResetDraws) -> EnvState:
        u = draws.uniform.to(self.dtype)
        q = uniform_between(u[:, 0:2], -math.pi, math.pi)
        r = uniform_between(u[:, 2:4], -0.8, 0.8)
        physics = torch.cat([q, torch.zeros_like(q), r], dim=1)
        return self._fresh(physics, self._obs(q, torch.zeros_like(q), r))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        phys = state.physics
        q, qdot, target = phys[:, :2], phys[:, 2:4], phys[:, 4:6]
        torque = torch.clamp(action.to(self.dtype), -1.0, 1.0)
        qdot = self.damping * qdot + torque * self.dt * 10.0
        q = q + qdot * self.dt
        tip = self._fingertip(q)
        dist = torch.sqrt(torch.sum((tip - target) ** 2, dim=1) + 1e-12)
        reward = -dist - 0.01 * torch.sum(torque**2, dim=1)
        step_count, done = self._time_limit(state)
        return state.replace(
            physics=torch.cat([q, qdot, target], dim=1), obs=self._obs(q, qdot, target),
            reward=reward, done=done, step_count=step_count,
        )


ENV_REGISTRY = {
    "Pendulum-v1": Pendulum,
    "PointMass2D-v0": PointMass2D,
    "Reacher2Link-v0": Reacher2Link,
}
_MJ_TASKS = ("HalfCheetah-v4", "Hopper-v4", "Walker2d-v4", "Ant-v4", "Humanoid-v4",
             "HumanoidStandup-v4")


def make_device_env(name: str, device=None, dtype: torch.dtype = torch.float32) -> DeviceEnv:
    """The env called ``name`` on ``device`` (None: CUDA): the three analytic
    envs, the planar MuJoCo tasks (``HopperPlanar-v0``,
    ``Walker2dPlanar-v0``, ``HalfCheetahPlanar-v0``) and the 3D ones
    (``Ant3D-v0``, ``Humanoid3D-v0``, ``HumanoidStandup3D-v0``). The JAX
    registry's other names raise ``NotImplementedError`` naming their
    ROADMAP item."""
    if name in ENV_REGISTRY:
        return ENV_REGISTRY[name](device=device, dtype=dtype)
    if name.endswith("Pixels-v0"):
        raise NotImplementedError(f"{name}: the pixel envs are not ported yet (ROADMAP A11)")
    if name.endswith("Planar-v0"):
        from .planar import PlanarMJCEnv

        return PlanarMJCEnv(name.replace("Planar-v0", "-v4"), device=device, dtype=dtype)
    if name in ("Ant3D-v0", "Humanoid3D-v0", "HumanoidStandup3D-v0"):
        from .rigid3d import Rigid3DEnv

        return Rigid3DEnv(name.replace("3D-v0", "-v4"), device=device, dtype=dtype)
    if name in _MJ_TASKS:
        raise NotImplementedError(f"{name}: the MJX adapter is not ported (ROADMAP A13); the "
                                  "planar tasks run as <Task>Planar-v0")
    raise ValueError(f"Unknown device env {name}; have {sorted(ENV_REGISTRY)} plus "
                     "HopperPlanar-v0/Walker2dPlanar-v0/HalfCheetahPlanar-v0 and "
                     "Ant3D-v0/Humanoid3D-v0/HumanoidStandup3D-v0")


# ---------------------------------------------------------------------------
# The fused loops
# ---------------------------------------------------------------------------


class Transitions(NamedTuple):
    """(T, N, ...) transitions of a fused rollout."""

    observations: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    next_observations: torch.Tensor
    dones: torch.Tensor  # terminated | truncated (episode boundaries)
    # real MDP termination only: what belongs in the replay ring's dones
    terminateds: torch.Tensor


class StepDraws(NamedTuple):
    """The draws of one collect step: the policy's, then the autoreset's."""

    policy: Any
    reset: ResetDraws


class CollectDraws(NamedTuple):
    """The draws of a collect: the first reset's (None where the collect
    continues from given env states) and each step's."""

    reset: Optional[ResetDraws]
    steps: List[StepDraws]


class EvalDraws(NamedTuple):
    """The draws of ``fused_eval``: the reset's, then each step's policy
    draws."""

    reset: ResetDraws
    steps: List[Any]


def draw_step(env: DeviceEnv, policy, num_envs: int, generator: torch.Generator) -> StepDraws:
    return StepDraws(policy.draw(num_envs, generator), env.draw_reset(num_envs, generator))


def draw_collect(env: DeviceEnv, policy, num_envs: int, num_steps: int,
                 generator: torch.Generator, reset: bool = True) -> CollectDraws:
    """The draws of a collect, in this order: the first reset's (with
    ``reset``), then per step the policy's and the autoreset's."""
    first = env.draw_reset(num_envs, generator) if reset else None
    return CollectDraws(first, [draw_step(env, policy, num_envs, generator)
                                for _ in range(num_steps)])


def draw_eval(env: DeviceEnv, policy, num_envs: int, num_steps: Optional[int],
              generator: torch.Generator) -> EvalDraws:
    """The draws of ``fused_eval``: the reset's, then each step's policy
    draws (``num_steps`` None: ``env.max_episode_steps``)."""
    num_steps = env.max_episode_steps if num_steps is None else num_steps
    first = env.draw_reset(num_envs, generator)
    return EvalDraws(first, [policy.draw(num_envs, generator) for _ in range(num_steps)])


def collect_step(env: DeviceEnv, policy_fn, state: EnvState, policy_state, draws: StepDraws):
    """One env step of the collect: the policy on the carried observations
    (``state.done`` marks the envs autoreset at the end of the previous
    step), then ``step_autoreset``. Returns (state, policy_state,
    transition), the transition a ``Transitions`` of (N, ...) tensors."""
    obs = state.obs
    actions, policy_state = policy_fn(obs, draws.policy, policy_state, state.done)
    next_state, true_next_obs = env.step_autoreset(state, actions, draws.reset)
    transition = Transitions(obs, actions, next_state.reward, true_next_obs, next_state.done,
                             next_state.terminated)
    return next_state, policy_state, transition


def stack_transitions(steps: List[Transitions]) -> Transitions:
    return Transitions(*[torch.stack(field) for field in zip(*steps)])


def fused_collect_stateful(
    env: DeviceEnv,
    policy_fn: Callable,
    draws: CollectDraws,
    policy_state,
    env_states: Optional[EnvState] = None,
) -> Tuple[Transitions, EnvState, Any]:
    """The fused collect with a policy that carries state across env steps:
    ``policy_fn(obs, step_draws, policy_state, reset_mask) -> (actions,
    policy_state)``, ``reset_mask`` (N,) bool True for the envs whose
    previous step ended an episode (the warm-start policy restarts their
    belief). Starts from ``env_states``, or from a reset with
    ``draws.reset``. Returns ``(transitions, env_states, policy_state)``,
    the transitions (T, N, ...)."""
    states = env_states if env_states is not None else env.reset(draws.reset)
    steps = []
    for step in draws.steps:
        states, policy_state, transition = collect_step(env, policy_fn, states, policy_state,
                                                        step)
        steps.append(transition)
    return stack_transitions(steps), states, policy_state


def stateful(policy_fn: Callable) -> Callable:
    """A stateless ``policy_fn(obs, draws) -> actions`` in the stateful
    form, carrying its state unchanged."""

    def call(obs, draws, policy_state, _reset_mask):
        return policy_fn(obs, draws), policy_state

    return call


def fused_collect(
    env: DeviceEnv,
    policy_fn: Callable,
    draws: CollectDraws,
    env_states: Optional[EnvState] = None,
) -> Tuple[Transitions, EnvState]:
    """``fused_collect_stateful`` with a stateless ``policy_fn(obs, draws)
    -> actions``. Returns ``(transitions, env_states)``."""
    transitions, states, _ = fused_collect_stateful(env, stateful(policy_fn), draws, (),
                                                    env_states)
    return transitions, states


def eval_step(env: DeviceEnv, policy_fn, state: EnvState, total: torch.Tensor,
              alive: torch.Tensor, draws):
    """One env step of ``fused_eval``: no autoreset; the rewards after an
    env's done are masked out."""
    actions = policy_fn(state.obs, draws)
    next_state = env.step(state, actions)
    total = total + alive * next_state.reward.to(total.dtype)
    alive = alive * (1.0 - next_state.done.to(total.dtype))
    return next_state, total, alive


def fused_eval(env: DeviceEnv, policy_fn: Callable, draws: EvalDraws) -> torch.Tensor:
    """Mean episodic return of ``policy_fn(obs, draws) -> actions`` over
    one fresh episode per env, ``len(draws.steps)`` steps at most (by
    default ``env.max_episode_steps``), with no autoreset; rewards after an
    env's done are masked out. A 0-d tensor on the env's device."""
    state = env.reset(draws.reset)
    n = state.obs.shape[0]
    total = torch.zeros(n, device=state.obs.device)
    alive = torch.ones(n, device=state.obs.device)
    for step in draws.steps:
        state, total, alive = eval_step(env, policy_fn, state, total, alive, step)
    return torch.mean(total)


def add_action_noise(env: DeviceEnv, action: torch.Tensor, noise: torch.Tensor, eps
                     ) -> torch.Tensor:
    """Exploration noise on a rollout action: ``action + noise * eps *
    half_range``, clipped to the env's bounds; ``noise`` is N(0, 1) of the
    action's shape and ``eps`` (a float or a 0-d tensor, so one captured
    collect serves a whole decay schedule) is in [-1, 1]-action units."""
    low, high = env._bounds()
    half = (high - low) * 0.5
    return torch.minimum(torch.maximum(action + noise * (eps * half), low), high)


class NoisyDraws(NamedTuple):
    policy: Any
    noise: torch.Tensor  # (N, A) N(0, 1)


class ExplorationNoise:
    """A rollout policy with ``add_action_noise`` on its actions (JAX
    ``with_exploration_noise``); stateful where the policy is. Its draws
    are the policy's, then the noise's."""

    def __init__(self, policy, env: DeviceEnv, eps):
        self.policy, self.env, self.eps = policy, env, eps
        self.stateful = getattr(policy, "stateful", False)

    def draw(self, num_envs: int, generator: torch.Generator) -> NoisyDraws:
        inner = self.policy.draw(num_envs, generator)
        noise = torch.randn((num_envs, self.env.action_dim), generator=generator,
                            device=self.env.device)
        return NoisyDraws(inner, noise)

    def __call__(self, obs, draws: NoisyDraws, *policy_state):
        out = self.policy(obs, draws.policy, *policy_state)
        if self.stateful:
            actions, state = out
            return add_action_noise(self.env, actions, draws.noise, self.eps), state
        return add_action_noise(self.env, out, draws.noise, self.eps)


def with_exploration_noise(policy, env: DeviceEnv, eps) -> ExplorationNoise:
    return ExplorationNoise(policy, env, eps)


def flatten_transitions(t: Transitions) -> Transitions:
    """(T, N, ...) -> (T * N, ...)."""
    return Transitions(*[x.reshape((-1,) + tuple(x.shape[2:])) for x in t])


# ---------------------------------------------------------------------------
# Rollout policies
# ---------------------------------------------------------------------------


class RolloutDraws(NamedTuple):
    """The draws of one rollout-policy call."""

    belief_noise: torch.Tensor  # (N, D): the sweep's start, or the posterior's eps
    seed: torch.Tensor  # 0-d int64: the sweep's in-sweep noise
    action_eps: Optional[torch.Tensor]  # (N, A); None for a deterministic policy
    fresh: Optional[torch.Tensor] = None  # (N, D): the warm policy's reset rows


def _policy_head(core, env: DeviceEnv, latent: torch.Tensor, action_eps, deterministic: bool
                 ) -> torch.Tensor:
    """The shared tail of the rollout policies: the policy's distribution,
    its (squashed) sample, the clip to [-1, 1], the env's action scaling."""
    dist = core.apply_policy(latent)
    action, _ = sample_action(dist, action_eps, deterministic=deterministic,
                              squash=core.policy_squash)
    return env.scale_action(torch.clamp(action, -1.0, 1.0))


class _Rollout:
    def __init__(self, core, env, deterministic, deterministic_beliefs, num_steps):
        self.core, self.env = core, env
        self.deterministic = deterministic
        self.belief_deterministic = deterministic or deterministic_beliefs
        self.num_steps = num_steps

    def _draw(self, num_envs: int, generator: torch.Generator, fresh: bool) -> RolloutDraws:
        dev, core = self.core.device, self.core
        fresh_noise = None
        if fresh:
            fresh_noise = torch.randn((num_envs, core.latent_dim), generator=generator, device=dev)
        start = core.draw_start(num_envs, generator)
        eps = None
        if not self.deterministic:
            eps = torch.randn((num_envs, core.action_dim), generator=generator, device=dev)
        return RolloutDraws(start.noise, start.seed, eps, fresh_noise)

    def _sweep(self, obs, draws: RolloutDraws, z_init=None) -> torch.Tensor:
        return self.core.beliefs_from_start(
            obs, draws.belief_noise, draws.seed, self.num_steps,
            deterministic=self.belief_deterministic, z_init=z_init,
            compute_reconstruction=False,
        ).latent


class RolloutPolicy(_Rollout):
    """``make_rollout_policy``'s policy: the belief (the reverse-diffusion
    sweep through the core's kernel dispatch, or with ``act_from_posterior``
    a posterior sample), then ``_policy_head``. It acts with the core's
    modules as they are: wrap calls in ``core.swapped(agent.acting_modules(
    state))`` to act with the EMAs. No Fokker-Planck refinement, as in the
    JAX rollout policy."""

    stateful = False

    def __init__(self, core, env, deterministic=False, act_from_posterior=False,
                 deterministic_beliefs=False, num_steps=None):
        super().__init__(core, env, deterministic, deterministic_beliefs, num_steps)
        self.act_from_posterior = act_from_posterior

    def draw(self, num_envs: int, generator: torch.Generator) -> RolloutDraws:
        """The sweep's start and seed (or the posterior's eps), then the
        action sample's eps unless deterministic."""
        return self._draw(num_envs, generator, fresh=False)

    @torch.no_grad()
    def __call__(self, obs: torch.Tensor, draws: RolloutDraws) -> torch.Tensor:
        obs = obs.to(torch.float32)
        if self.act_from_posterior:
            eps = None if self.belief_deterministic else draws.belief_noise
            latent = self.core.sample_posterior(obs, eps)
        else:
            latent = self._sweep(obs, draws)
        return _policy_head(self.core, self.env, latent, draws.action_eps, self.deterministic)


class WarmRolloutPolicy(_Rollout):
    """``make_warm_rollout_policy``'s policy: each sweep starts from the
    previous step's belief forward-noised to the truncation step, with
    ``num_steps`` reverse steps; the envs flagged in ``reset_mask`` start
    from fresh N(0, I) latents. ``__call__(obs, draws, prev_latent,
    reset_mask) -> (actions, latent)``."""

    stateful = True

    def __init__(self, core, env, num_steps: int, deterministic=False,
                 deterministic_beliefs=False):
        super().__init__(core, env, deterministic, deterministic_beliefs, num_steps)

    def draw(self, num_envs: int, generator: torch.Generator) -> RolloutDraws:
        """The reset rows' fresh latents, the sweep's forward noise and seed,
        then the action sample's eps unless deterministic."""
        return self._draw(num_envs, generator, fresh=True)

    @torch.no_grad()
    def __call__(self, obs, draws: RolloutDraws, prev_latent, reset_mask):
        obs = obs.to(torch.float32)
        z_prev = torch.where(reset_mask[:, None], draws.fresh, prev_latent)
        latent = self._sweep(obs, draws, z_init=z_prev)
        return _policy_head(self.core, self.env, latent, draws.action_eps,
                            self.deterministic), latent


def make_rollout_policy(core, env, *, deterministic=False, act_from_posterior=False,
                        deterministic_beliefs=False, num_steps=None) -> RolloutPolicy:
    return RolloutPolicy(core, env, deterministic, act_from_posterior, deterministic_beliefs,
                         num_steps)


def make_warm_rollout_policy(core, env, *, num_steps: int, deterministic=False,
                             deterministic_beliefs=False) -> WarmRolloutPolicy:
    return WarmRolloutPolicy(core, env, num_steps, deterministic, deterministic_beliefs)


def init_warm_state(num_envs: int, latent_dim: int, generator: torch.Generator
                    ) -> torch.Tensor:
    """The first warm-start belief carry: N(0, I), so every env's first
    sweep behaves as a reset env's."""
    return torch.randn((num_envs, latent_dim), generator=generator, device=generator.device)
