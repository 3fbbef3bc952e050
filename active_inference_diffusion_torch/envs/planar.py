"""Planar rigid-body physics for the 2D MuJoCo tasks, batched over envs.

Counterpart of ``active_inference_diffusion_tpu/envs/planar.py`` (:64-771):
``PlanarModel``, ``forward_kinematics``, ``com_positions``,
``mass_matrix``, ``bias_forces``, ``_contact_points``, ``contact_forces``
(the penalty model), ``passive_and_limit_forces``, ``applied_torques``,
``qacc``, ``_limited_joints``, ``contact_projection``, ``step_physics`` and
``PlanarMJCEnv``. Hopper-v4, Walker2d-v4 and HalfCheetah-v4 are planar
kinematic trees (slide-x, slide-z, hinge-y root and hinge joints), so their
smooth dynamics are exact; ground contact is the JAX engine's approximation
(projected Gauss-Seidel impulses by default, or the penalty springs).

The constants come from ``envs/planar_models.py``, which
``tools/extract_planar_models.py`` wrote from the Gymnasium XMLs (nothing
here reads MuJoCo), as float64, cast to the run's type.

Every function takes (N, nq) coordinates. Where the JAX engine takes M and
its Jacobian by ``jax.jacfwd``, this one computes the same quantities in
closed form for a planar tree, with no autodiff:

- kinematics: every frame angle is linear in q (``Tpre`` before a joint,
  ``T`` of a body), and every position a sum of rotated constant offsets,
  gathered by the tree's constant ancestor matrices;
- a point X on body b moves with joint j (if j is on b's path) by
  ``s_j W (X - A_j)`` for a hinge (anchor A_j, sign s_j, W the derivative
  of the planar rotation) and ``R(Tpre_j) axis_j`` for a slide: the point
  Jacobians, and M = sum_b m_b Jc_b^T Jc_b + sum_b Iyy_b Jt_b^T Jt_b (the
  second term constant) + diag(armature);
- the bias c(q, qd) = sum_b m_b Jc_b^T (Jc_b-dot qd + g e_z), Kane's form
  of the Lagrangian's Coriolis and gravity terms, with Jc_b-dot qd from the
  anchors' and centres' velocities.

Solves factor the symmetric positive definite M by ``cholesky_ex`` and use
triangular solves, which never read the device from the host, so a CUDA
graph can capture a step.
The projected Gauss-Seidel keeps the JAX engine's rows in its order (the
limits, then per contact point its normal and its friction row) and its 8
sweeps.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.active_inference import resolve_device
from .device_envs import DeviceEnv, EnvState, ResetDraws
from .mujoco_tasks import (
    TASK_SPECS,
    MjPhysicsFields,
    reset_qpos_qvel,
    task_observation,
    task_reward,
    task_terminated,
)
from .planar_models import MODELS

_SLIDE = 2  # mujoco mjtJoint values
_HINGE = 3

_FLOAT_FIELDS = ("body_pos", "body_ipos", "mass", "iyy", "jnt_axis", "jnt_sign", "jnt_anchor",
                 "qpos0", "jnt_range", "jnt_limited", "damping", "armature", "stiffness",
                 "springref", "gear", "ctrlrange", "geom_a", "geom_b", "geom_radius",
                 "cp_offset", "cp_radius", "cp_friction")


class PlanarModel:
    """The static description of one task's planar tree, as tensors of the
    run's type on one device (None: CUDA, which must exist), and the
    constant matrices of its tree:
    ``aff`` (nbody, nj) joint j moves body b; ``pre`` (nj, nj) joint k moves
    the frame joint j is applied in; ``anc`` (nbody, nbody) body a is on the
    path to body b; ``s`` the hinges' signs (0 on slides); ``m_rot`` the
    constant rotational part of M plus the armature; ``act_map`` (nu, nj)
    the gears from actuators to dofs."""

    def __init__(self, env_name: str, device=None, dtype: torch.dtype = torch.float32,
                 contact_stiffness: float = 1.0e4, contact_damping: float = 6.0e2,
                 slip_velocity: float = 0.05, limit_stiffness: float = 3.0e3,
                 limit_damping: float = 30.0, contact_model: str = "constraint"):
        raw = MODELS[env_name]
        self.env_name = env_name
        self.device = resolve_device(device)
        self.dtype = dtype
        self.parent = tuple(raw["parent"])
        self.jnt_body = tuple(raw["jnt_body"])
        self.jnt_type = tuple(raw["jnt_type"])
        self.act_dof = tuple(raw["act_dof"])
        self.geom_body = tuple(raw["geom_body"])
        self.cp_body = tuple(raw["cp_body"])
        # the fields rounded to the run's type, and their values in float64
        exact = {f: torch.tensor(raw[f], dtype=dtype).to(torch.float64) for f in _FLOAT_FIELDS}
        for f, value in exact.items():
            setattr(self, f, value.to(device=self.device, dtype=dtype))
        self.dt = float(raw["dt"])
        self.gravity = float(raw["gravity"])
        self.use_rk4 = bool(raw["use_rk4"])
        self.n_substeps = int(raw["n_substeps"])
        self.contact_stiffness = contact_stiffness
        self.contact_damping = contact_damping
        self.slip_velocity = slip_velocity
        self.limit_stiffness = limit_stiffness
        self.limit_damping = limit_damping
        self.contact_model = contact_model

        nbody, nj = len(self.parent), len(self.jnt_body)
        anc = np.zeros((nbody, nbody))
        for b in range(1, nbody):
            a = b
            while a != 0:
                anc[a, b] = 1.0
                a = self.parent[a]
        aff = np.array([[anc[self.jnt_body[j], b] for j in range(nj)] for b in range(nbody)])
        pre = np.zeros((nj, nj))
        for j in range(nj):
            bj = self.jnt_body[j]
            for k in range(nj):
                bk = self.jnt_body[k]
                pre[k, j] = float((bk != bj and anc[bk, bj] > 0) or (bk == bj and k < j))
        hinge = np.array([t == _HINGE for t in self.jnt_type], np.float64)
        s = exact["jnt_sign"].numpy() * hinge
        j_theta = aff * s[None, :]
        m_rot = (np.einsum("b,bj,bk->jk", exact["iyy"].numpy(), j_theta, j_theta)
                 + np.diag(exact["armature"].numpy()))
        act_map = np.zeros((len(self.act_dof), nj))
        for a, dof in enumerate(self.act_dof):
            act_map[a, dof] = exact["gear"].numpy()[a]

        def const(x):
            return torch.tensor(x, dtype=torch.float64).to(device=self.device, dtype=dtype)

        self.anc, self.aff, self.pre, self.s = const(anc), const(aff), const(pre), const(s)
        self.m_rot, self.act_map = const(m_rot), const(act_map)
        self.limited = _limited_joints(self)
        self.cp_aff = self.aff[list(self.cp_body)]  # (ncp, nj)
        # index tensors on the device: a captured step must not copy an
        # index list from the host
        def index(x):
            return torch.tensor(x, dtype=torch.int64, device=self.device)

        self.parent_idx, self.jnt_body_idx = index(self.parent), index(self.jnt_body)
        self.cp_body_idx, self.limited_idx = index(self.cp_body), index(self.limited)
        self.cp_mu = [float(x) for x in exact["cp_friction"]]
        self.eye = torch.eye(nj, dtype=dtype, device=self.device)

    @property
    def nbody(self) -> int:
        return len(self.parent)

    @property
    def nj(self) -> int:
        return len(self.jnt_body)


def _rotate(c: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(theta) v for theta given by its cos ``c`` and sin ``s`` (...,) and
    v (..., 2): x' = c x + s z, z' = -s x + c z (a rotation about +y)."""
    x, z = v[..., 0], v[..., 1]
    return torch.stack([c * x + s * z, c * z - s * x], dim=-1)


def _w(v: torch.Tensor) -> torch.Tensor:
    """W v, with d/dtheta R(theta) = W R(theta): (z, -x)."""
    return torch.stack([v[..., 1], -v[..., 0]], dim=-1)


class Kinematics(NamedTuple):
    pos: torch.Tensor  # (N, nbody, 2) body frame origins
    theta: torch.Tensor  # (N, nbody) body frame angles
    anchor: torch.Tensor  # (N, nj, 2) joint anchors in the world
    slide: torch.Tensor  # (N, nj, 2) slide directions in the world (0 on hinges)


def _kinematics(model: PlanarModel, qpos: torch.Tensor) -> Kinematics:
    q = qpos - model.qpos0
    sq = q * model.s
    t_pre = sq @ model.pre  # the frame angle each joint is applied in
    t_post = t_pre + sq
    theta = sq @ model.aff.T
    t_parent = theta[:, model.parent_idx]
    body_terms = _rotate(torch.cos(t_parent), torch.sin(t_parent), model.body_pos)
    c_pre, s_pre = torch.cos(t_pre), torch.sin(t_pre)
    anchor_pre = _rotate(c_pre, s_pre, model.jnt_anchor)
    slide = _rotate(c_pre, s_pre, model.jnt_axis)
    # each joint's displacement of the frames after it: a slide translates
    # along its axis, a hinge turns the frame about its anchor
    delta = (slide * q[..., None] + anchor_pre
             - _rotate(torch.cos(t_post), torch.sin(t_post), model.jnt_anchor))
    along = torch.einsum("ab,nax->nbx", model.anc, body_terms)
    pos = along + torch.einsum("bj,njx->nbx", model.aff, delta)
    frame = along[:, model.jnt_body_idx] + torch.einsum("kj,nkx->njx", model.pre, delta)
    return Kinematics(pos, theta, frame + anchor_pre, slide)


def forward_kinematics(model: PlanarModel, qpos: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Body frame positions (N, nbody, 2) and angles (N, nbody), MuJoCo's
    joint composition relative to ``qpos0``."""
    kin = _kinematics(model, qpos)
    return kin.pos, kin.theta


def _attached(kin: Kinematics, bodies: Optional[torch.Tensor], offsets: torch.Tensor
              ) -> torch.Tensor:
    """World positions (N, K, 2) of points at ``offsets`` (K, 2) in the frames
    of ``bodies`` (an index tensor; None: every body, in order)."""
    th, pos = kin.theta, kin.pos
    if bodies is not None:
        th, pos = th[:, bodies], pos[:, bodies]
    return pos + _rotate(torch.cos(th), torch.sin(th), offsets)


def com_positions(model: PlanarModel, qpos: torch.Tensor) -> torch.Tensor:
    return _attached(_kinematics(model, qpos), None, model.body_ipos)


def _contact_points(model: PlanarModel, qpos: torch.Tensor) -> torch.Tensor:
    """World positions of the contact candidate points, (N, ncp, 2)."""
    return _attached(_kinematics(model, qpos), model.cp_body_idx, model.cp_offset)


def _point_jacobian(model: PlanarModel, kin: Kinematics, points: torch.Tensor,
                    aff: torch.Tensor) -> torch.Tensor:
    """d points / d q, (N, K, 2, nj), for points (N, K, 2) whose bodies'
    rows of ``aff`` are ``aff`` (K, nj)."""
    rel = points[:, :, None, :] - kin.anchor[:, None, :, :]
    per_joint = _w(rel) * model.s[:, None] + kin.slide[:, None]
    return (per_joint * aff[None, :, :, None]).transpose(-1, -2)


class _Dynamics(NamedTuple):
    kin: Kinematics
    com: torch.Tensor  # (N, nbody, 2)
    jac: torch.Tensor  # (N, nbody, 2, nj)
    mass_matrix: torch.Tensor  # (N, nj, nj)


def _mass(model: PlanarModel, qpos: torch.Tensor) -> _Dynamics:
    kin = _kinematics(model, qpos)
    com = _attached(kin, None, model.body_ipos)
    jac = _point_jacobian(model, kin, com, model.aff)
    m = torch.einsum("b,nbxj,nbxk->njk", model.mass, jac, jac) + model.m_rot
    return _Dynamics(kin, com, jac, m)


def mass_matrix(model: PlanarModel, qpos: torch.Tensor) -> torch.Tensor:
    """M(q), (N, nj, nj)."""
    return _mass(model, qpos).mass_matrix


def _bias(model: PlanarModel, dyn: _Dynamics, qvel: torch.Tensor) -> torch.Tensor:
    kin = dyn.kin
    hinge_rate = qvel * model.s  # (N, nj) signed hinge rates
    slide_vel = kin.slide * qvel[..., None]  # (N, nj, 2)
    omega_pre = hinge_rate @ model.pre  # angular velocity of the frame before each joint
    omega = hinge_rate @ model.aff.T  # (N, nbody)
    turn = kin.anchor * hinge_rate[..., None]
    v_anchor = (_w(kin.anchor * omega_pre[..., None] - torch.einsum("kj,nkx->njx", model.pre, turn))
                + torch.einsum("kj,nkx->njx", model.pre, slide_vel))
    v_com = torch.einsum("nbxj,nj->nbx", dyn.jac, qvel)
    # Jc-dot qd: a hinge's column turns with the relative velocity of the
    # point and the anchor, a slide's with the frame it slides in
    inner = (omega[..., None] * v_com
             - torch.einsum("bj,njx->nbx", model.aff, v_anchor * hinge_rate[..., None])
             + torch.einsum("bj,njx->nbx", model.aff, slide_vel * omega_pre[..., None]))
    accel = _w(inner)
    accel = torch.stack([accel[..., 0], accel[..., 1] + model.gravity], dim=-1)
    return torch.einsum("b,nbxj,nbx->nj", model.mass, dyn.jac, accel)


def bias_forces(model: PlanarModel, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """c(q, qd) with gravity, so that M qdd + c = tau (MuJoCo's ``mj_rne``
    with flg_acc=0), (N, nj)."""
    return _bias(model, _mass(model, qpos), qvel)


def contact_forces(model: PlanarModel, qpos: torch.Tensor, qvel: torch.Tensor) -> torch.Tensor:
    """The penalty model's generalised contact forces: a one-sided
    spring-damper normal and tanh-regularised Coulomb friction at each
    candidate point, through the point Jacobians, (N, nj)."""
    kin = _kinematics(model, qpos)
    points = _attached(kin, model.cp_body_idx, model.cp_offset)
    jac = _point_jacobian(model, kin, points, model.cp_aff)
    vel = torch.einsum("npxj,nj->npx", jac, qvel)
    pen = model.cp_radius - points[..., 1]
    fn = torch.where(pen > 0.0,
                     model.contact_stiffness * pen - model.contact_damping * vel[..., 1],
                     torch.zeros_like(pen))
    fn = torch.clamp_min(fn, 0.0)
    ft = -model.cp_friction * fn * torch.tanh(vel[..., 0] / model.slip_velocity)
    return torch.einsum("npxj,npx->nj", jac, torch.stack([ft, fn], dim=-1))


def passive_and_limit_forces(model: PlanarModel, qpos: torch.Tensor, qvel: torch.Tensor
                             ) -> torch.Tensor:
    """Joint damping and spring stiffness (MuJoCo's qfrc_passive); in the
    penalty model also one-sided joint-limit springs (in the constraint
    model the limits are impulses)."""
    passive = -model.damping * qvel - model.stiffness * (qpos - model.springref)
    if model.contact_model == "constraint":
        return passive
    lo, hi = model.jnt_range[:, 0], model.jnt_range[:, 1]
    below = torch.clamp_min(lo - qpos, 0.0)
    above = torch.clamp_min(qpos - hi, 0.0)
    viol = below - above
    in_violation = ((below > 0) | (above > 0)).to(qpos.dtype)
    limit = model.jnt_limited * (model.limit_stiffness * viol
                                 - model.limit_damping * in_violation * qvel)
    return passive + limit


def applied_torques(model: PlanarModel, ctrl: torch.Tensor) -> torch.Tensor:
    """The actuators' joint torques, with ``ctrl`` clamped to the ctrlrange
    as MuJoCo clamps data.ctrl."""
    ctrl = torch.minimum(torch.maximum(ctrl, model.ctrlrange[:, 0]), model.ctrlrange[:, 1])
    return ctrl @ model.act_map


def _cholesky(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cholesky_ex(m).L


def _solve(m: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """M^-1 rhs by two triangular solves on M's Cholesky factor: no host
    read of the factorisation's status, so a graph can capture it."""
    chol = _cholesky(m)
    y = torch.linalg.solve_triangular(chol, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]


def _inverse(m: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """M^-1 = L^-T L^-1 from M's Cholesky factor L."""
    inv_l = torch.linalg.solve_triangular(_cholesky(m), eye.expand_as(m), upper=False)
    return inv_l.mT @ inv_l


def _qacc(model, dyn: _Dynamics, qpos, qvel, ctrl, implicit_damping_dt: float) -> torch.Tensor:
    m = dyn.mass_matrix
    if implicit_damping_dt:
        m = m + torch.diag(implicit_damping_dt * model.damping)
    rhs = (applied_torques(model, ctrl) + passive_and_limit_forces(model, qpos, qvel)
           - _bias(model, dyn, qvel))
    if model.contact_model != "constraint":
        rhs = rhs + contact_forces(model, qpos, qvel)
    return _solve(m, rhs)


def qacc(model: PlanarModel, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor,
         implicit_damping_dt: float = 0.0) -> torch.Tensor:
    """Smooth (and penalty-contact) forward dynamics; ``implicit_damping_dt``
    > 0 adds h diag(damping) to M, as MuJoCo's Euler integrator treats
    joint damping implicitly."""
    return _qacc(model, _mass(model, qpos), qpos, qvel, ctrl, implicit_damping_dt)


def _limited_joints(model: PlanarModel) -> List[int]:
    """The limited joints (one dof each, so joint index == dof index)."""
    limited = model.jnt_limited.cpu().numpy()
    return [j for j in range(model.nj) if float(limited[j]) > 0.0]


def _project(model: PlanarModel, dyn: _Dynamics, qpos: torch.Tensor, qvel: torch.Tensor,
             h: float, n_iters: int, beta: float, max_bias_vel: float) -> torch.Tensor:
    dtype = qpos.dtype
    points = _attached(dyn.kin, model.cp_body_idx, model.cp_offset)
    jac = _point_jacobian(model, dyn.kin, points, model.cp_aff)
    pen = model.cp_radius - points[..., 1]
    c_active = (pen > 0.0).to(dtype)
    c_bias = torch.clamp_max(beta * torch.clamp_min(pen, 0.0) / h, max_bias_vel)
    jn, jt = jac[:, :, 1, :], jac[:, :, 0, :]  # world-z and world-x rows (N, ncp, nj)
    lim = model.limited_idx
    lo, hi = model.jnt_range[lim, 0], model.jnt_range[lim, 1]
    q_l = qpos[:, lim]
    c_lo, c_hi = lo - q_l, q_l - hi
    n_l = torch.where(c_lo > c_hi, 1.0, -1.0).to(dtype)
    viol = torch.clamp_min(torch.maximum(c_lo, c_hi), 0.0)
    l_active = (viol > 0.0).to(dtype)
    l_bias = torch.clamp_max(beta * viol / h, max_bias_vel)

    minv = _inverse(dyn.mass_matrix, model.eye)
    eps = 1e-9
    cols_n = minv @ jn.transpose(1, 2)  # (N, nj, ncp): dv per unit normal impulse
    a_n = torch.einsum("npi,nip->np", jn, cols_n) + eps
    cols_t = minv @ jt.transpose(1, 2)
    a_t = torch.einsum("npi,nip->np", jt, cols_t) + eps
    cols_l = minv[:, :, lim] * n_l[:, None, :]
    a_l = torch.diagonal(minv[:, lim][:, :, lim], dim1=1, dim2=2) + eps

    # per-row views and constants, made once for all sweeps: the reciprocal
    # of each row's diagonal and, for the projection onto [0, inf) of an
    # active row or {0} of an inactive one, an upper bound of +inf or 0
    inf = torch.full_like(c_active, float("inf"))
    ub_c = torch.where(c_active > 0, inf, torch.zeros_like(c_active))
    ub_l = torch.where(l_active > 0, inf[:, :1], torch.zeros_like(l_active))
    zero = torch.zeros_like(qvel[:, 0])
    rows_l = [(l_bias[:, i], n_l[:, i], 1.0 / a_l[:, i], ub_l[:, i], cols_l[:, :, i], j)
              for i, j in enumerate(model.limited)]
    rows_c = [(jn[:, p], c_bias[:, p], 1.0 / a_n[:, p], ub_c[:, p], cols_n[:, :, p],
               jt[:, p], -1.0 / a_t[:, p], cols_t[:, :, p], model.cp_mu[p])
              for p in range(len(model.cp_body))]
    v = qvel
    lam_l = [zero] * len(rows_l)
    lam_n = [zero] * len(rows_c)
    lam_t = [zero] * len(rows_c)
    for _ in range(n_iters):
        for i, (bias, n, inv_a, ub, col, j) in enumerate(rows_l):
            new = torch.clamp(torch.addcmul(lam_l[i], bias - n * v[:, j], inv_a), zero, ub)
            v = torch.addcmul(v, col, (new - lam_l[i])[:, None])
            lam_l[i] = new
        for p, (row_n, bias, inv_a, ub, col_n, row_t, neg_inv_at, col_t, mu_p) in enumerate(
                rows_c):
            new = torch.clamp(torch.addcmul(lam_n[p], bias - (row_n * v).sum(-1), inv_a), zero, ub)
            v = torch.addcmul(v, col_n, (new - lam_n[p])[:, None])
            lam_n[p] = new
            # friction: the Coulomb box of the normal impulse (0 on an inactive row)
            cone = mu_p * new
            new_t = torch.clamp(torch.addcmul(lam_t[p], (row_t * v).sum(-1), neg_inv_at),
                                -cone, cone)
            v = torch.addcmul(v, col_t, (new_t - lam_t[p])[:, None])
            lam_t[p] = new_t
    return v


def contact_projection(model: PlanarModel, qpos: torch.Tensor, qvel: torch.Tensor, h: float,
                       n_iters: int = 8, beta: float = 0.2, max_bias_vel: float = 2.0
                       ) -> torch.Tensor:
    """Ground contact and joint limits as velocity-level unilateral
    constraints, solved by projected Gauss-Seidel impulses (JAX
    ``contact_projection``): per sweep, each violated limit's row along
    +-e_j, then for each penetrating point its normal row (Baumgarte bias,
    capped at ``max_bias_vel``) and its friction row clamped to the Coulomb
    box of the normal impulse; impulses couple through M^-1. Returns the
    projected velocities (N, nj)."""
    return _project(model, _mass(model, qpos), qpos, qvel, h, n_iters, beta, max_bias_vel)


def step_physics(model: PlanarModel, qpos: torch.Tensor, qvel: torch.Tensor, ctrl: torch.Tensor,
                 frame_skip: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance ``frame_skip`` model timesteps with this model's integrator
    (RK4, or implicit-damping semi-implicit Euler), each in
    ``model.n_substeps`` substeps; in the constraint model each substep ends
    (RK4) or projects before the position update (Euler) with
    ``contact_projection``."""
    h = model.dt / model.n_substeps
    constraint = model.contact_model == "constraint"
    ctrl = ctrl.to(qpos.dtype)
    q, qd = qpos, qvel
    for _ in range(frame_skip * model.n_substeps):
        if model.use_rk4:
            def deriv(qq, vv):
                return vv, qacc(model, qq, vv, ctrl)

            k1q, k1v = deriv(q, qd)
            k2q, k2v = deriv(q + 0.5 * h * k1q, qd + 0.5 * h * k1v)
            k3q, k3v = deriv(q + 0.5 * h * k2q, qd + 0.5 * h * k2v)
            k4q, k4v = deriv(q + h * k3q, qd + h * k3v)
            q = q + (h / 6.0) * (k1q + 2 * k2q + 2 * k3q + k4q)
            qd = qd + (h / 6.0) * (k1v + 2 * k2v + 2 * k3v + k4v)
            if constraint:
                qd = contact_projection(model, q, qd, h)
        else:
            dyn = _mass(model, q)
            qd = qd + h * _qacc(model, dyn, q, qd, ctrl, h)
            if constraint:  # before the position update, at the same q
                qd = _project(model, dyn, q, qd, h, 8, 0.2, 2.0)
            q = q + h * qd
    return q, qd


class PlanarMJCEnv(DeviceEnv):
    """The planar engine under the exact Gymnasium ``-v4`` task semantics
    (``envs/mujoco_tasks.py``) for Hopper, Walker2d and HalfCheetah. Returns
    are not comparable to ``gym.make``'s: the contact solve approximates
    MuJoCo's."""

    PLANAR_TASKS = ("Hopper-v4", "Walker2d-v4", "HalfCheetah-v4")

    def __init__(self, env_name: str, device=None, dtype: torch.dtype = torch.float32):
        if env_name not in self.PLANAR_TASKS:
            raise ValueError(f"{env_name} is not a planar task; have {self.PLANAR_TASKS}")
        super().__init__(device, dtype)
        self.env_name = env_name
        self.spec = TASK_SPECS[env_name]
        self.model = PlanarModel(env_name, self.device, dtype)
        self.nq = self.model.nj
        self.observation_dim = (self.nq - self.spec.exclude_positions) + self.nq
        self.action_dim = len(self.model.act_dof)
        self.action_low = self.model.ctrlrange[:, 0].to(torch.float32)
        self.action_high = self.model.ctrlrange[:, 1].to(torch.float32)
        self.max_episode_steps = self.spec.max_episode_steps
        self.dt = float(self.model.dt * self.spec.frame_skip)
        self.model_timestep = float(self.model.dt)
        normal = self.spec.qvel_noise == "normal"
        self.reset_uniforms = self.nq if normal else 2 * self.nq
        self.reset_normals = self.nq if normal else 0

    def _fields(self, qpos, qvel) -> MjPhysicsFields:
        return MjPhysicsFields(qpos=qpos, qvel=qvel)

    def reset(self, draws: ResetDraws) -> EnvState:
        """qpos0 plus U(+-s) noise; qvel s N(0, 1) (HalfCheetah) or U(+-s).
        ``draws.uniform`` (N, nq) for qpos, then (N, nq) for a uniform qvel
        noise; ``draws.normal`` (N, nq) for a normal one."""
        nq = self.nq
        init_q = self.model.qpos0.expand(draws.uniform.shape[0], nq)
        v_draw = draws.normal if draws.normal is not None else draws.uniform[:, nq:]
        qpos, qvel = reset_qpos_qvel(self.spec, init_q, torch.zeros_like(init_q),
                                     draws.uniform[:, :nq], v_draw)
        return self._fresh(torch.cat([qpos, qvel], dim=1),
                           task_observation(self.spec, self._fields(qpos, qvel)))

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        qpos, qvel = state.physics[:, : self.nq], state.physics[:, self.nq:]
        before = self._fields(qpos, qvel)
        qpos, qvel = step_physics(self.model, qpos, qvel, action, self.spec.frame_skip)
        after = self._fields(qpos, qvel)
        reward = task_reward(self.spec, before, after, action, self.dt,
                             model_timestep=self.model_timestep)
        terminated = task_terminated(self.spec, qpos, qvel)
        step_count, truncated = self._time_limit(state)
        return state.replace(
            physics=torch.cat([qpos, qvel], dim=1),
            obs=task_observation(self.spec, after), reward=reward.to(self.dtype),
            done=terminated | truncated, terminated=terminated, step_count=step_count,
        )
