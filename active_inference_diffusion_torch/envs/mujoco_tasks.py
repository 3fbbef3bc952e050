"""Gymnasium MuJoCo ``-v4`` task semantics as batched torch functions.

Counterpart of ``active_inference_diffusion_tpu/envs/mujoco_tasks.py``:
``MjPhysicsFields``, ``MjTaskSpec`` and ``TASK_SPECS`` (the data, every
entry), ``observation_dim``, ``task_observation``, ``is_healthy``,
``task_terminated``, ``forward_position``, ``task_reward`` and
``reset_qpos_qvel``. Every tensor carries a leading env axis: ``qpos`` is
(N, nq), ``qvel`` (N, nv), a reward (N,). The reset takes its draws as
tensors (unit-uniform numbers, or standard normals for a normal velocity
noise) instead of a key, so a test can hand both packages the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch


class MjPhysicsFields(NamedTuple):
    """The physics outputs the -v4 semantics read, batched over envs. The
    humanoid-family fields stay None for the planar tasks."""

    qpos: torch.Tensor
    qvel: torch.Tensor
    cinert: Optional[torch.Tensor] = None  # (N, nbody, 10)
    cvel: Optional[torch.Tensor] = None  # (N, nbody, 6)
    qfrc_actuator: Optional[torch.Tensor] = None  # (N, nv)
    cfrc_ext: Optional[torch.Tensor] = None  # (N, nbody, 6)
    xipos: Optional[torch.Tensor] = None  # (N, nbody, 3)
    torso_xpos: Optional[torch.Tensor] = None  # (N, 3)


@dataclass(frozen=True)
class MjTaskSpec:
    """Static -v4 task description (the JAX module's fields and defaults)."""

    name: str
    xml_file: str
    frame_skip: int
    forward_reward_weight: float = 1.0
    ctrl_cost_weight: float = 0.0
    healthy_reward: float = 0.0
    terminate_when_unhealthy: bool = False
    healthy_z_range: Optional[Tuple[float, float]] = None
    healthy_angle_range: Optional[Tuple[float, float]] = None
    healthy_state_range: Optional[Tuple[float, float]] = None
    check_finite_healthy: bool = False
    inclusive_z: bool = False
    exclude_positions: int = 1
    clip_qvel_obs: Optional[float] = None
    full_body_obs: bool = False
    use_contact_forces: bool = False
    contact_cost_weight: float = 5e-4
    contact_force_range: Tuple[float, float] = (-1.0, 1.0)
    forward_from: Optional[str] = "x"
    standup: bool = False
    reset_noise_scale: float = 0.0
    qvel_noise: str = "uniform"  # "uniform" | "normal"
    max_episode_steps: int = 1000


TASK_SPECS = {
    "HalfCheetah-v4": MjTaskSpec(
        name="HalfCheetah-v4", xml_file="half_cheetah.xml", frame_skip=5,
        ctrl_cost_weight=0.1, reset_noise_scale=0.1, qvel_noise="normal",
    ),
    "Hopper-v4": MjTaskSpec(
        name="Hopper-v4", xml_file="hopper.xml", frame_skip=4,
        ctrl_cost_weight=1e-3, healthy_reward=1.0,
        terminate_when_unhealthy=True,
        healthy_z_range=(0.7, float("inf")),
        healthy_angle_range=(-0.2, 0.2),
        healthy_state_range=(-100.0, 100.0),
        clip_qvel_obs=10.0, reset_noise_scale=5e-3,
    ),
    "Walker2d-v4": MjTaskSpec(
        name="Walker2d-v4", xml_file="walker2d.xml", frame_skip=4,
        ctrl_cost_weight=1e-3, healthy_reward=1.0,
        terminate_when_unhealthy=True,
        healthy_z_range=(0.8, 2.0),
        healthy_angle_range=(-1.0, 1.0),
        clip_qvel_obs=10.0, reset_noise_scale=5e-3,
    ),
    "Ant-v4": MjTaskSpec(
        name="Ant-v4", xml_file="ant.xml", frame_skip=5,
        ctrl_cost_weight=0.5, healthy_reward=1.0,
        terminate_when_unhealthy=True,
        healthy_z_range=(0.2, 1.0), check_finite_healthy=True,
        inclusive_z=True, exclude_positions=2,
        forward_from="torso",
        reset_noise_scale=0.1, qvel_noise="normal",
    ),
    "Humanoid-v4": MjTaskSpec(
        name="Humanoid-v4", xml_file="humanoid.xml", frame_skip=5,
        forward_reward_weight=1.25, ctrl_cost_weight=0.1,
        healthy_reward=5.0, terminate_when_unhealthy=True,
        healthy_z_range=(1.0, 2.0), exclude_positions=2,
        full_body_obs=True, forward_from="com",
        reset_noise_scale=1e-2,
    ),
    "HumanoidStandup-v4": MjTaskSpec(
        name="HumanoidStandup-v4", xml_file="humanoidstandup.xml",
        frame_skip=5, exclude_positions=2, full_body_obs=True,
        forward_from=None, standup=True, reset_noise_scale=1e-2,
    ),
}


def observation_dim(spec: MjTaskSpec, nq: int, nv: int, nbody: int) -> int:
    dim = (nq - spec.exclude_positions) + nv
    if spec.full_body_obs:
        dim += nbody * 10 + nbody * 6 + nv + nbody * 6
    if spec.use_contact_forces:
        dim += nbody * 6
    return dim


def task_observation(spec: MjTaskSpec, f: MjPhysicsFields) -> torch.Tensor:
    """The -v4 observation, (N, obs_dim)."""
    n = f.qpos.shape[0]
    velocity = f.qvel
    if spec.clip_qvel_obs is not None:
        velocity = torch.clamp(velocity, -spec.clip_qvel_obs, spec.clip_qvel_obs)
    parts = [f.qpos[:, spec.exclude_positions:], velocity]
    if spec.full_body_obs:
        parts += [f.cinert.reshape(n, -1), f.cvel.reshape(n, -1),
                  f.qfrc_actuator.reshape(n, -1), f.cfrc_ext.reshape(n, -1)]
    if spec.use_contact_forces:
        lo, hi = spec.contact_force_range
        parts.append(torch.clamp(f.cfrc_ext, lo, hi).reshape(n, -1))
    return torch.cat(parts, dim=1)


def is_healthy(spec: MjTaskSpec, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """(N,) bool: the -v4 healthy-state predicate (True where no range is set)."""
    healthy = torch.ones(qpos.shape[0], dtype=torch.bool, device=qpos.device)
    if spec.healthy_z_range is not None:
        z = qpos[:, 2] if spec.exclude_positions == 2 else qpos[:, 1]
        lo, hi = spec.healthy_z_range
        if spec.inclusive_z:
            healthy = healthy & (lo <= z) & (z <= hi)
        else:
            healthy = healthy & (lo < z) & (z < hi)
    if spec.healthy_angle_range is not None:
        angle = qpos[:, 2]
        lo, hi = spec.healthy_angle_range
        healthy = healthy & (lo < angle) & (angle < hi)
    if spec.healthy_state_range is not None:
        state = torch.cat([qpos, qvel], dim=1)[:, 2:]
        lo, hi = spec.healthy_state_range
        healthy = healthy & torch.all((lo < state) & (state < hi), dim=1)
    if spec.check_finite_healthy:
        healthy = healthy & torch.all(torch.isfinite(torch.cat([qpos, qvel], dim=1)), dim=1)
    return healthy


def task_terminated(spec: MjTaskSpec, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    if not spec.terminate_when_unhealthy:
        return torch.zeros(qpos.shape[0], dtype=torch.bool, device=qpos.device)
    return ~is_healthy(spec, qpos, qvel)


def forward_position(spec: MjTaskSpec, f: MjPhysicsFields,
                     body_mass: Optional[torch.Tensor]) -> torch.Tensor:
    """(N,): the x-coordinate whose per-step change is forward progress."""
    if spec.forward_from == "x":
        return f.qpos[:, 0]
    if spec.forward_from == "torso":
        return f.torso_xpos[:, 0]
    if spec.forward_from == "com":
        num = torch.einsum("b,nbj->nj", body_mass, f.xipos)
        return (num / torch.sum(body_mass))[:, 0]
    raise ValueError(f"{spec.name} has no forward-progress term")


def task_reward(
    spec: MjTaskSpec,
    f_before: MjPhysicsFields,
    f_after: MjPhysicsFields,
    action: torch.Tensor,
    dt: float,
    body_mass: Optional[torch.Tensor] = None,
    model_timestep: Optional[float] = None,
) -> torch.Tensor:
    """The -v4 reward, (N,). ``dt`` is timestep * frame_skip; the standup
    task divides by the raw ``model_timestep``."""
    ctrl_cost = spec.ctrl_cost_weight * torch.sum(torch.square(action), dim=1)
    if spec.standup:
        uph_cost = f_after.qpos[:, 2] / model_timestep
        quad_ctrl_cost = 0.1 * torch.sum(torch.square(action), dim=1)
        quad_impact_cost = torch.clamp_max(
            0.5e-6 * torch.sum(torch.square(f_after.cfrc_ext).flatten(1), dim=1), 10.0)
        return uph_cost - quad_ctrl_cost - quad_impact_cost + 1.0
    x_before = forward_position(spec, f_before, body_mass)
    x_after = forward_position(spec, f_after, body_mass)
    forward_reward = spec.forward_reward_weight * (x_after - x_before) / dt
    # the healthy reward is paid every step while terminate_when_unhealthy,
    # else only where healthy (hopper_v4.py's healthy_reward property)
    if spec.terminate_when_unhealthy:
        healthy = torch.ones_like(forward_reward)
    else:
        healthy = is_healthy(spec, f_after.qpos, f_after.qvel).to(forward_reward.dtype)
    reward = forward_reward + spec.healthy_reward * healthy - ctrl_cost
    if spec.use_contact_forces:
        lo, hi = spec.contact_force_range
        clipped = torch.clamp(f_after.cfrc_ext, lo, hi)
        reward = reward - spec.contact_cost_weight * torch.sum(
            torch.square(clipped).flatten(1), dim=1)
    return reward


def uniform_between(u: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jax.random.uniform(minval=lo, maxval=hi)`` from its unit-uniform
    numbers ``u``: ``max(lo, u (hi - lo) + lo)`` in ``u``'s type (for
    symmetric bounds hi - lo rounds as JAX's difference of the rounded
    bounds does: scaling by 2 is exact)."""
    return torch.clamp_min(u * (hi - lo) + lo, lo)


def reset_qpos_qvel(
    spec: MjTaskSpec,
    init_qpos: torch.Tensor,
    init_qvel: torch.Tensor,
    uniform_q: torch.Tensor,
    draw_v: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-task -v4 reset noise around the keyframe state, (N, nq) and
    (N, nv). ``uniform_q`` (N, nq) are unit-uniform numbers; ``draw_v`` (N,
    nv) are standard normals where ``spec.qvel_noise`` is "normal", else
    unit-uniform numbers."""
    s = spec.reset_noise_scale
    qpos = init_qpos + uniform_between(uniform_q.to(init_qpos.dtype), -s, s)
    draw_v = draw_v.to(init_qvel.dtype)
    if spec.qvel_noise == "normal":
        qvel = init_qvel + s * draw_v
    else:
        qvel = init_qvel + uniform_between(draw_v, -s, s)
    return qpos, qvel
