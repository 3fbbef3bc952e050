"""3D rigid-body physics for Ant, Humanoid and HumanoidStandup, batched over
envs.

Counterpart of ``active_inference_diffusion_tpu/envs/rigid3d.py`` (:55-903):
``Rigid3DModel``, the quaternion helpers, ``integrate_pos``,
``forward_kinematics``, ``chart``, ``mass_matrix``, ``bias_forces``, the
contact point forces, ``contact_forces``, ``contact_wrenches``,
``passive_and_limit_forces`` (constraint limits), ``applied_torques``,
``body_velocities``, ``com_frame_fields``, ``qacc``, ``_limited_hinges``,
``limit_projection``, ``step_physics`` and ``Rigid3DEnv``. The trees are a
free root (joint 0 on body 1) and hinges; ground contact is the JAX
engine's penalty approximation, joint limits its projected Gauss-Seidel
impulses. The ``spring`` limit model is not ported (ROADMAP A12).

The constants come from ``envs/rigid3d_models.py``, which
``tools/extract_rigid3d_models.py`` wrote from the Gymnasium XMLs with
MuJoCo (nothing here reads MuJoCo), as float64, cast to the run's type.

Every function takes (N, nq) configurations and (N, nv) velocities in
MuJoCo's convention (free joint: world-frame linear velocity of the root's
origin, body-frame angular velocity), the JAX engine's chart at u = 0.
Where the JAX engine differentiates the chart by ``jax.jacfwd``, ``jvp``
and ``grad``, this one uses closed forms:

- each dof d has a world rotation axis s_d (a hinge's axis in its frame,
  the root's body axes; 0 for the root's translations) through an anchor
  p_d, and a translation t_d (e_k for the root's translations); a point X
  on body b moves with the dofs that move b by ``s_d x (X - p_d) + t_d``:
  the point Jacobians, and M = sum_b m_b Jc_b^T Jc_b + Jw_b^T I_b Jw_b +
  diag(armature), as JAX's M(u) at u = 0;
- the bias is Newton-Euler (Kane's form): with Jdot v from the axes'
  turning (``w_pre,d x s_d``, the frame a dof is applied in) and the
  anchors' velocities, c = sum_b Jc_b^T m_b (a_b + g e_z) + Jw_b^T (I_b
  alpha_b + w_b x I_b w_b). This is the Christoffel form JAX takes of its
  exact M(u) (the chart's velocity map is the identity to first order at
  u = 0), so the two agree to rounding.

Solves factor M by ``cholesky_ex`` and use triangular solves, which never
read the device from the host, so a CUDA graph can capture a step. The
contact wrenches are summed per body by a constant one-hot product, in a
fixed order (no atomics). The limit projection keeps JAX's rows (the
limited hinges in model order) and its 8 sweeps.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..core.active_inference import resolve_device
from .device_envs import DeviceEnv, EnvState, ResetDraws
from .mujoco_tasks import (
    TASK_SPECS,
    MjPhysicsFields,
    observation_dim,
    reset_qpos_qvel,
    task_observation,
    task_reward,
    task_terminated,
)
from .rigid3d_models import MODELS

_FREE = 0  # mujoco mjtJoint values
_HINGE = 3

# the fields the constraint-limit engine reads (the render geoms wait for the
# pixel envs, the limit springs for the spring limit model)
_FLOAT_FIELDS = ("body_pos", "body_rot", "body_ipos", "mass", "inertia", "jnt_axis",
                 "jnt_anchor", "qpos0", "jnt_range", "jnt_limited", "damping", "armature",
                 "stiffness", "springref", "ctrlrange", "cp_offset", "cp_radius",
                 "cp_friction", "cp_k", "cp_c")


class Rigid3DModel:
    """The static description of one task's 3D tree, as tensors of the
    run's type on one device (None: CUDA, which must exist), and the
    constant matrices of its tree: ``aff`` (nbody, nv) dof d moves body b;
    ``pre`` (nv, nv) dof e moves the frame dof d is applied in (for the
    root's rotations only its translations); ``trans`` (nv, 3) the root's
    translations; ``act_map`` (nu, nv) the gears; ``cp_sum`` (nbody, ncp)
    the contact points' bodies, one-hot."""

    def __init__(self, env_name: str, device=None, dtype: torch.dtype = torch.float32):
        raw = MODELS[env_name]
        self.env_name = env_name
        self.device = resolve_device(device)
        self.dtype = dtype
        for field in ("parent", "jnt_body", "jnt_type", "jnt_qposadr", "jnt_dofadr", "act_dof",
                      "cp_body"):
            setattr(self, field, tuple(raw[field]))
        self.nq, self.nv = int(raw["nq"]), int(raw["nv"])
        self.dt, self.gravity = float(raw["dt"]), float(raw["gravity"])
        self.n_substeps = int(raw["n_substeps"])
        self.slip_velocity, self.max_qvel = float(raw["slip_velocity"]), float(raw["max_qvel"])
        nbody, nj, nv = len(self.parent), len(self.jnt_body), self.nv
        # the free root, then one hinge a joint: hinge j's coordinate is
        # qpos[6 + j], its dof 5 + j
        if (self.jnt_type[0] != _FREE or self.jnt_body[0] != 1
                or any(t != _HINGE for t in self.jnt_type[1:])
                or self.jnt_qposadr != tuple([0] + list(range(7, 6 + nj)))
                or self.jnt_dofadr != tuple([0] + list(range(6, 5 + nj)))):
            raise ValueError(f"{env_name}: expected a free root and hinges in order")
        for f in _FLOAT_FIELDS:
            value = torch.tensor(raw[f], dtype=dtype)
            setattr(self, f, value.to(self.device))
        self.hinges_of = [[j for j in range(1, nj) if self.jnt_body[j] == b]
                          for b in range(nbody)]

        anc = np.zeros((nbody, nbody))  # anc[a, b]: body a is on the path to body b
        for b in range(1, nbody):
            a = b
            while a != 0:
                anc[a, b] = 1.0
                a = self.parent[a]
        dof_body = [1] * 6 + [self.jnt_body[j] for j in range(1, nj)]
        aff = np.array([[anc[dof_body[d], b] for d in range(nv)] for b in range(nbody)])
        pre = np.zeros((nv, nv))
        pre[0:3, 3:6] = 1.0
        for d in range(6, nv):
            bd = dof_body[d]
            for e in range(nv):
                be = dof_body[e]
                pre[e, d] = float((be != bd and anc[be, bd] > 0) or (be == bd and e < d))
        trans = np.zeros((nv, 3))
        trans[0:3] = np.eye(3)
        gear = torch.tensor(raw["gear"], dtype=dtype).to(torch.float64).numpy()
        act_map = np.zeros((len(self.act_dof), nv))
        for a, dof in enumerate(self.act_dof):
            act_map[a, dof] = gear[a]
        cp_sum = np.zeros((nbody, len(self.cp_body)))
        cp_sum[list(self.cp_body), np.arange(len(self.cp_body))] = 1.0

        def const(x):
            return torch.tensor(x, dtype=torch.float64).to(device=self.device, dtype=dtype)

        self.aff, self.pre, self.trans = const(aff), const(pre), const(trans)
        self.act_map, self.cp_sum = const(act_map), const(cp_sum)
        self.cp_aff = self.aff[list(self.cp_body)]  # (ncp, nv)
        self.limited = _limited_hinges(self)
        # index tensors on the device: a captured step must not copy an
        # index list from the host
        def index(x):
            return torch.tensor(x, dtype=torch.int64, device=self.device)

        self.cp_body_idx = index(self.cp_body)
        self.lim_idx = index(self.limited)
        self.lim_qadr = index([self.jnt_qposadr[j] for j in self.limited])
        self.lim_dadr = index([self.jnt_dofadr[j] for j in self.limited])
        self.eye = torch.eye(nv, dtype=dtype, device=self.device)
        self.e_z = const([0.0, 0.0, 1.0])

    @property
    def nbody(self) -> int:
        return len(self.parent)


# ---------------------------------------------------------------------------
# Quaternion helpers (w, x, y, z), batched over leading axes
# ---------------------------------------------------------------------------


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternions -> (..., 3, 3) rotation matrices."""
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_exp(v: torch.Tensor) -> torch.Tensor:
    """exp of rotation vectors (..., 3) (angle = |v|) as quaternions; the
    series below angle^2 = 1e-16 (both branches are evaluated, so the
    square root keeps its 1e-24)."""
    angle_sq = torch.sum(v * v, dim=-1)
    angle = torch.sqrt(angle_sq + 1e-24)
    half = 0.5 * angle
    s = torch.where(angle_sq > 1e-16, torch.sin(half) / angle, 0.5 - angle_sq / 48.0)
    return torch.cat([torch.cos(half)[..., None], s[..., None] * v], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)


def integrate_pos(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor, dt
                  ) -> torch.Tensor:
    """MuJoCo's mj_integratePos: the root's linear velocity in the world
    frame, its angular velocity as a local quaternion exponential; hinges
    add."""
    pos = qpos[:, 0:3] + dt * qvel[:, 0:3]
    quat = quat_mul(qpos[:, 3:7], quat_exp(dt * qvel[:, 3:6]))
    rest = qpos[:, 7:] + dt * qvel[:, 6:]
    return torch.cat([pos, quat_normalize(quat), rest], dim=1)


def chart(model: Rigid3DModel, qpos: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """phi(q, u): tangent coordinates -> configuration (u-dot = qvel at u=0)."""
    return integrate_pos(model, qpos, u, 1.0)


# ---------------------------------------------------------------------------
# Kinematics, M and the bias
# ---------------------------------------------------------------------------


class Kinematics(NamedTuple):
    pos: torch.Tensor  # (N, nbody, 3) body frame origins
    rot: torch.Tensor  # (N, nbody, 3, 3) body frame rotations
    axis: torch.Tensor  # (N, nv, 3) each dof's world rotation axis (0 on translations)
    anchor: torch.Tensor  # (N, nv, 3) each dof's anchor (0 on translations)


def _kinematics(model: Rigid3DModel, qpos: torch.Tensor) -> Kinematics:
    n, dtype = qpos.shape[0], qpos.dtype
    zero = torch.zeros((n, 3), dtype=dtype, device=qpos.device)
    ang = qpos[:, 7:] - model.qpos0[7:]
    hinge_rot = quat_to_mat(quat_exp(model.jnt_axis[1:] * ang[..., None]))  # (N, nh, 3, 3)
    pos, rot = [zero], [model.eye[:3, :3].expand(n, 3, 3)]
    axis, anchor = [zero] * 3, [zero] * 3
    for b in range(1, model.nbody):
        if b == 1:  # the free joint: qpos holds the root's world pose
            p = qpos[:, 0:3]
            r = quat_to_mat(quat_normalize(qpos[:, 3:7]))
            axis += list(r.unbind(-1))  # the body axes: body-frame angular velocity
            anchor += [p] * 3
        else:
            parent = model.parent[b]
            p = pos[parent] + rot[parent] @ model.body_pos[b]
            r = rot[parent] @ model.body_rot[b]
            for j in model.hinges_of[b]:
                a = p + r @ model.jnt_anchor[j]
                axis.append(r @ model.jnt_axis[j])
                anchor.append(a)
                r = r @ hinge_rot[:, j - 1]
                p = a - r @ model.jnt_anchor[j]
        pos.append(p)
        rot.append(r)
    return Kinematics(torch.stack(pos, dim=1), torch.stack(rot, dim=1),
                      torch.stack(axis, dim=1), torch.stack(anchor, dim=1))


def forward_kinematics(model: Rigid3DModel, qpos: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Body poses: positions (N, nbody, 3) and rotations (N, nbody, 3, 3)."""
    kin = _kinematics(model, qpos)
    return kin.pos, kin.rot


def _attached(kin: Kinematics, bodies, offsets: torch.Tensor) -> torch.Tensor:
    """World positions (N, K, 3) of points at ``offsets`` (K, 3) in the frames
    of ``bodies`` (an index tensor; None: every body, in order)."""
    pos, rot = kin.pos, kin.rot
    if bodies is not None:
        pos, rot = pos[:, bodies], rot[:, bodies]
    return pos + torch.einsum("nkij,kj->nki", rot, offsets)


def _point_jacobian(model: Rigid3DModel, kin: Kinematics, points: torch.Tensor,
                    aff: torch.Tensor) -> torch.Tensor:
    """d points / d u at u = 0, (N, K, nv, 3), for points (N, K, 3) whose
    bodies' rows of ``aff`` are ``aff`` (K, nv)."""
    rel = points[:, :, None, :] - kin.anchor[:, None, :, :]
    cols = torch.linalg.cross(kin.axis[:, None].expand_as(rel), rel, dim=-1) + model.trans
    return cols * aff[None, :, :, None]


class _Dynamics(NamedTuple):
    kin: Kinematics
    com: torch.Tensor  # (N, nbody, 3)
    jac: torch.Tensor  # (N, nbody, nv, 3) the CoMs' Jacobians
    jac_w: torch.Tensor  # (N, nbody, nv, 3) world angular-velocity Jacobians
    inertia_w: torch.Tensor  # (N, nbody, 3, 3) world-frame rotational inertias
    mass_matrix: torch.Tensor  # (N, nv, nv)


def _mass(model: Rigid3DModel, qpos: torch.Tensor) -> _Dynamics:
    kin = _kinematics(model, qpos)
    com = _attached(kin, None, model.body_ipos)
    jac = _point_jacobian(model, kin, com, model.aff)
    jac_w = kin.axis[:, None] * model.aff[None, :, :, None]
    inertia_w = kin.rot @ model.inertia @ kin.rot.mT
    m = (torch.einsum("b,nbdx,nbex->nde", model.mass, jac, jac)
         + torch.einsum("nbdx,nbxy,nbey->nde", jac_w, inertia_w, jac_w)
         + torch.diag(model.armature))
    return _Dynamics(kin, com, jac, jac_w, inertia_w, m)


def mass_matrix(model: Rigid3DModel, qpos: torch.Tensor) -> torch.Tensor:
    """M(q) in qvel space, (N, nv, nv)."""
    return _mass(model, qpos).mass_matrix


def _bias(model: Rigid3DModel, dyn: _Dynamics, qvel: torch.Tensor) -> torch.Tensor:
    kin = dyn.kin
    axis, anchor = kin.axis, kin.anchor
    # the angular velocity of the frame each dof is applied in, and the
    # turning of its axis with that frame
    w_pre = torch.einsum("ed,nex,ne->ndx", model.pre, axis, qvel)
    s_dot = torch.linalg.cross(w_pre, axis, dim=-1)
    # the anchors' velocities, as points of the frames before their dofs
    rel = anchor[:, None, :, :] - anchor[:, :, None, :]  # [n, e, d] = p_d - p_e
    cols = torch.linalg.cross(axis[:, :, None].expand_as(rel), rel, dim=-1) + model.trans[:, None]
    v_anchor = torch.einsum("ed,nedx,ne->ndx", model.pre, cols, qvel)
    w = torch.einsum("bd,ndx,nd->nbx", model.aff, axis, qvel)
    alpha = torch.einsum("bd,ndx,nd->nbx", model.aff, s_dot, qvel)
    v_com = torch.einsum("nbdx,nd->nbx", dyn.jac, qvel)
    # Jdot v of the CoMs: d/dt [s_d x (X - p_d)] = s_dot_d x (X - p_d) + s_d x (Xdot - pdot_d)
    rel_c = dyn.com[:, :, None, :] - anchor[:, None, :, :]
    turn = torch.linalg.cross(s_dot[:, None].expand_as(rel_c), rel_c, dim=-1)
    slide = torch.linalg.cross(axis[:, None].expand_as(rel_c),
                               v_com[:, :, None, :] - v_anchor[:, None, :, :], dim=-1)
    accel = torch.einsum("bd,nbdx,nd->nbx", model.aff, turn + slide, qvel)
    force = model.mass[:, None] * (accel + model.gravity * model.e_z)
    iw = (dyn.inertia_w @ w[..., None])[..., 0]
    torque = ((dyn.inertia_w @ alpha[..., None])[..., 0]
              + torch.linalg.cross(w, iw, dim=-1))
    return (torch.einsum("nbdx,nbx->nd", dyn.jac, force)
            + torch.einsum("nbdx,nbx->nd", dyn.jac_w, torque))


def bias_forces(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """c(q, qd) with gravity, so that M qdd + c = tau (MuJoCo's ``mj_rne``
    with flg_acc=0; JAX's Christoffel form in the exact chart), (N, nv)."""
    return _bias(model, _mass(model, qpos), qvel)


# ---------------------------------------------------------------------------
# Contacts, passive forces, actuators
# ---------------------------------------------------------------------------


def _contact_point_forces(model: Rigid3DModel, kin: Kinematics, qvel: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point world contact forces: (P (N, ncp, 3) world points, F (N,
    ncp, 3) forces, J (N, ncp, nv, 3) point Jacobians)."""
    points = _attached(kin, model.cp_body_idx, model.cp_offset)
    jac = _point_jacobian(model, kin, points, model.cp_aff)
    vel = torch.einsum("npdx,nd->npx", jac, qvel)
    pen = model.cp_radius - points[..., 2]
    fn = torch.where(pen > 0.0, model.cp_k * pen - model.cp_c * vel[..., 2],
                     torch.zeros_like(pen))
    fn = torch.clamp_min(fn, 0.0)
    mu = model.cp_friction
    ftx = -mu * fn * torch.tanh(vel[..., 0] / model.slip_velocity)
    fty = -mu * fn * torch.tanh(vel[..., 1] / model.slip_velocity)
    return points, torch.stack([ftx, fty, fn], dim=-1), jac


def contact_forces(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """The penalty contacts' generalised forces, (N, nv): a one-sided
    spring-damper normal (per-point constants) and tanh-regularised Coulomb
    friction at each candidate point against the z = 0 plane."""
    _, force, jac = _contact_point_forces(model, _kinematics(model, qpos), qvel)
    return torch.einsum("npdx,npx->nd", jac, force)


def _wrenches(model: Rigid3DModel, kin: Kinematics, qvel: torch.Tensor, origin: torch.Tensor
              ) -> torch.Tensor:
    points, force, _ = _contact_point_forces(model, kin, qvel)
    torque = torch.linalg.cross(points - origin[:, None, :], force, dim=-1)
    return torch.einsum("bp,npk->nbk", model.cp_sum, torch.cat([torque, force], dim=-1))


def contact_wrenches(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor,
                     origin: torch.Tensor) -> torch.Tensor:
    """Per-body contact wrench about ``origin`` (N, 3) in world axes,
    (N, nbody, 6): rotation then translation, the penalty model's stand-in
    for MuJoCo's cfrc_ext; summed per body by a one-hot product."""
    return _wrenches(model, _kinematics(model, qpos), qvel, origin)


def passive_and_limit_forces(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor
                             ) -> torch.Tensor:
    """Joint damping and the hinges' springs (MuJoCo's qfrc_passive); the
    limits are impulses (``limit_projection``), not forces."""
    spring = -model.stiffness[1:] * (qpos[:, 7:] - model.springref[7:])
    damping = -model.damping * qvel
    return torch.cat([damping[:, :6], damping[:, 6:] + spring], dim=1)


def applied_torques(model: Rigid3DModel, ctrl: torch.Tensor) -> torch.Tensor:
    """The actuators' joint torques, with ``ctrl`` clamped to the ctrlrange
    as MuJoCo clamps data.ctrl."""
    ctrl = torch.minimum(torch.maximum(ctrl, model.ctrlrange[:, 0]), model.ctrlrange[:, 1])
    return ctrl @ model.act_map


def body_velocities(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor):
    """(coms, rot, w_world, v_com): per-body CoM positions, rotations,
    world-frame angular velocities and CoM linear velocities."""
    dyn = _mass(model, qpos)
    return _body_velocities(dyn, qvel)


def _body_velocities(dyn: _Dynamics, qvel: torch.Tensor):
    w_world = torch.einsum("nbdx,nd->nbx", dyn.jac_w, qvel)
    v_com = torch.einsum("nbdx,nd->nbx", dyn.jac, qvel)
    return dyn.com, dyn.kin.rot, w_world, v_com


def _com_frame_fields(model: Rigid3DModel, dyn: _Dynamics, qvel: torch.Tensor,
                      ctrl: torch.Tensor) -> dict:
    coms, rot, w_world, v_com = _body_velocities(dyn, qvel)
    mass = model.mass
    subtree_com = torch.einsum("b,nbi->ni", mass, coms) / torch.sum(mass)
    r = coms - subtree_com[:, None, :]
    r2 = torch.sum(r * r, dim=-1)
    eye = model.eye[:3, :3]
    ic = dyn.inertia_w + mass[:, None, None] * (r2[..., None, None] * eye
                                                 - r[..., :, None] * r[..., None, :])
    cinert = torch.cat([
        ic[..., 0, 0:1], ic[..., 1, 1:2], ic[..., 2, 2:3],
        ic[..., 0, 1:2], ic[..., 0, 2:3], ic[..., 1, 2:3],
        mass[:, None] * r, mass[:, None].expand(r.shape[0], -1, 1),
    ], dim=-1)
    cvel = torch.cat([w_world, v_com + torch.linalg.cross(r, w_world, dim=-1)], dim=-1)
    return {"cinert": cinert, "cvel": cvel, "qfrc_actuator": applied_torques(model, ctrl),
            "cfrc_ext": _wrenches(model, dyn.kin, qvel, subtree_com), "xipos": coms}


def com_frame_fields(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor,
                     ctrl: torch.Tensor) -> dict:
    """The c-frame quantities of Humanoid-v4's 376-dim observation in
    MuJoCo's layouts: cinert (N, nbody, 10), cvel (N, nbody, 6),
    qfrc_actuator (N, nv), cfrc_ext (N, nbody, 6, the penalty contacts
    about the root's subtree CoM) and xipos (N, nbody, 3)."""
    return _com_frame_fields(model, _mass(model, qpos), qvel, ctrl)


# ---------------------------------------------------------------------------
# Forward dynamics, the limit projection, the integrator
# ---------------------------------------------------------------------------


def _solve(m: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M^-1 rhs by two triangular solves on M's Cholesky factor: no host
    read of the factorisation's status, so a graph can capture it."""
    chol = torch.linalg.cholesky_ex(m).L
    y = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]


def qacc(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor
         ) -> torch.Tensor:
    """Forward dynamics with the penalty contacts, (N, nv)."""
    dyn = _mass(model, qpos)
    _, force, jac = _contact_point_forces(model, dyn.kin, qvel)
    rhs = (applied_torques(model, ctrl) + passive_and_limit_forces(model, qpos, qvel)
           + torch.einsum("npdx,npx->nd", jac, force) - _bias(model, dyn, qvel))
    return _solve(dyn.mass_matrix, rhs)


def _limited_hinges(model: Rigid3DModel) -> List[int]:
    """The limited hinges' joint indices, in model order."""
    limited = model.jnt_limited.cpu().numpy()
    return [j for j in range(len(model.jnt_body))
            if model.jnt_type[j] == _HINGE and float(limited[j]) > 0.0]


def limit_projection(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor, h: float,
                     n_iters: int = 8, beta: float = 0.2, max_bias_vel: float = 2.0
                     ) -> torch.Tensor:
    """Joint limits as velocity-level unilateral constraints (JAX
    ``limit_projection``): for each limited hinge in violation an impulse
    lambda >= 0 along the outward normal (+-e_dof) enforces n v' >= bias,
    bias = min(beta C / h, ``max_bias_vel``); the impulses couple through
    M^-1 and are solved by ``n_iters`` projected Gauss-Seidel sweeps over
    the limited hinges in model order. Returns the projected velocities."""
    if not model.limited:
        return qvel
    lo, hi = model.jnt_range[model.lim_idx, 0], model.jnt_range[model.lim_idx, 1]
    q = qpos[:, model.lim_qadr]
    c_lo, c_hi = lo - q, q - hi
    n = torch.where(c_lo > c_hi, 1.0, -1.0).to(qpos.dtype)
    viol = torch.clamp_min(torch.maximum(c_lo, c_hi), 0.0)
    active = (viol > 0.0).to(qpos.dtype)
    bias = torch.clamp_max(beta * viol / h, max_bias_vel)

    chol = torch.linalg.cholesky_ex(mass_matrix(model, qpos)).L
    inv_l = torch.linalg.solve_triangular(chol, model.eye.expand_as(chol), upper=False)
    minv = inv_l.mT @ inv_l
    dadr = model.lim_dadr
    cols = minv[:, :, dadr] * n[:, None, :]  # dv per unit impulse, (N, nv, nl)
    a_diag = torch.diagonal(minv[:, dadr][:, :, dadr], dim1=1, dim2=2)
    rows = [(bias[:, i], n[:, i], a_diag[:, i], active[:, i], cols[:, :, i], model.jnt_dofadr[j])
            for i, j in enumerate(model.limited)]
    v = qvel
    lam = [torch.zeros_like(qvel[:, 0])] * len(rows)
    for _ in range(n_iters):
        for i, (b, n_i, a_i, act_i, col, d) in enumerate(rows):
            new = torch.clamp_min(lam[i] + (b - n_i * v[:, d]) / a_i, 0.0) * act_i
            v = torch.addcmul(v, col, (new - lam[i])[:, None])
            lam[i] = new
    return v


def step_physics(model: Rigid3DModel, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor,
                 frame_skip: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Manifold RK4 (stage configurations by ``integrate_pos``), ``frame_skip
    x n_substeps`` substeps, each ending with ``limit_projection`` and the
    ``max_qvel`` clamp (JAX ``step_physics``, :771-799, line for line)."""
    h = model.dt / model.n_substeps
    ctrl = ctrl.to(qpos.dtype)
    q, qd = qpos, qvel
    for _ in range(frame_skip * model.n_substeps):
        k1 = qacc(model, q, qd, ctrl)
        q2 = integrate_pos(model, q, qd, 0.5 * h)
        k2 = qacc(model, q2, qd + 0.5 * h * k1, ctrl)
        q3 = integrate_pos(model, q, qd + 0.5 * h * k1, 0.5 * h)
        k3 = qacc(model, q3, qd + 0.5 * h * k2, ctrl)
        q4 = integrate_pos(model, q, qd + 0.5 * h * k2, h)
        k4 = qacc(model, q4, qd + h * k3, ctrl)
        vel_mean = (qd + 2.0 * (qd + 0.5 * h * k1) + 2.0 * (qd + 0.5 * h * k2)
                    + (qd + h * k3)) / 6.0
        q_new = integrate_pos(model, q, vel_mean, h)
        qd_new = qd + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        qd_new = limit_projection(model, q_new, qd_new, h)
        q, qd = q_new, torch.clamp(qd_new, -model.max_qvel, model.max_qvel)
    return q, qd


# ---------------------------------------------------------------------------
# The env
# ---------------------------------------------------------------------------


class Rigid3DEnv(DeviceEnv):
    """The 3D engine under the exact Gymnasium ``-v4`` task semantics
    (``envs/mujoco_tasks.py``) for Ant, Humanoid and HumanoidStandup;
    Humanoid's 376-dim observation from ``com_frame_fields``. Returns are
    not comparable to ``gym.make``'s: the contacts are penalty forces."""

    TASKS = ("Ant-v4", "Humanoid-v4", "HumanoidStandup-v4")

    def __init__(self, env_name: str, device=None, dtype: torch.dtype = torch.float32):
        if env_name not in self.TASKS:
            raise ValueError(f"{env_name} is not a 3D task; have {self.TASKS}")
        super().__init__(device, dtype)
        self.env_name = env_name
        self.spec = TASK_SPECS[env_name]
        self.model = Rigid3DModel(env_name, self.device, dtype)
        self.nq, self.nv, self.nbody = self.model.nq, self.model.nv, self.model.nbody
        self.observation_dim = observation_dim(self.spec, self.nq, self.nv, self.nbody)
        self.action_dim = len(self.model.act_dof)
        self.action_low = self.model.ctrlrange[:, 0].to(torch.float32)
        self.action_high = self.model.ctrlrange[:, 1].to(torch.float32)
        self.max_episode_steps = self.spec.max_episode_steps
        self.dt = float(self.model.dt * self.spec.frame_skip)
        self.model_timestep = float(self.model.dt)
        self.full_body = self.spec.full_body_obs or self.spec.standup
        normal = self.spec.qvel_noise == "normal"
        self.reset_uniforms = self.nq if normal else self.nq + self.nv
        self.reset_normals = self.nv if normal else 0

    def _fields(self, qpos, qvel, ctrl) -> MjPhysicsFields:
        if self.full_body:
            dyn = _mass(self.model, qpos)
            cf = _com_frame_fields(self.model, dyn, qvel, ctrl)
            return MjPhysicsFields(qpos=qpos, qvel=qvel, torso_xpos=dyn.kin.pos[:, 1], **cf)
        pos, _ = forward_kinematics(self.model, qpos)
        return MjPhysicsFields(qpos=qpos, qvel=qvel, torso_xpos=pos[:, 1])

    def reset(self, draws: ResetDraws) -> EnvState:
        """qpos0 plus U(+-s) noise on every coordinate (the quaternion's too,
        then normalised, as MuJoCo normalises gym's noisy quaternion); qvel
        s N(0, 1) (Ant) or U(+-s). ``draws.uniform`` (N, nq) for qpos, then
        (N, nv) for a uniform qvel noise; ``draws.normal`` (N, nv) for a
        normal one."""
        nq, n = self.nq, draws.uniform.shape[0]
        init_q = self.model.qpos0.expand(n, nq)
        init_v = torch.zeros((n, self.nv), dtype=self.dtype, device=init_q.device)
        v_draw = draws.normal if draws.normal is not None else draws.uniform[:, nq:]
        qpos, qvel = reset_qpos_qvel(self.spec, init_q, init_v, draws.uniform[:, :nq], v_draw)
        qpos = torch.cat([qpos[:, 0:3], quat_normalize(qpos[:, 3:7]), qpos[:, 7:]], dim=1)
        ctrl = torch.zeros((n, self.action_dim), dtype=self.dtype, device=init_q.device)
        return self._fresh(torch.cat([qpos, qvel], dim=1),
                           task_observation(self.spec, self._fields(qpos, qvel, ctrl)))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        qpos, qvel = state.physics[:, : self.nq], state.physics[:, self.nq:]
        action = action.to(self.dtype)
        before = self._fields(qpos, qvel, action)
        qpos, qvel = step_physics(self.model, qpos, qvel, action, self.spec.frame_skip)
        after = self._fields(qpos, qvel, action)
        reward = task_reward(self.spec, before, after, action, self.dt,
                             body_mass=self.model.mass, model_timestep=self.model_timestep)
        terminated = task_terminated(self.spec, qpos, qvel)
        step_count, truncated = self._time_limit(state)
        return state.replace(
            physics=torch.cat([qpos, qvel], dim=1),
            obs=task_observation(self.spec, after), reward=reward.to(self.dtype),
            done=terminated | truncated, terminated=terminated, step_count=step_count,
        )
