"""Write ``envs/rigid3d_models.py``: the 3D models' constants as literals.

    python active_inference_diffusion_torch/tools/extract_rigid3d_models.py [OUT]

Reads the Gymnasium MuJoCo XMLs of Ant-v4, Humanoid-v4 and
HumanoidStandup-v4 through the host ``mujoco`` binding, as the JAX
package's ``envs/rigid3d.py::extract_rigid3d_model`` (:128-309) does with
its defaults (``contact_omega`` 0.25 / dt_sub, ``contact_zeta`` 1,
``slip_velocity`` 0.05, ``n_substeps`` 1, ``max_qvel`` 100, constraint
joint limits), and writes each task's fields as float64 (and integer)
literals: the body tree, body frames and inertias (rotated out of the
inertial frame), joints, actuators, contact candidate points (capsule ends
and centre, sphere centres, the floor's friction folded in), the render
geoms, and the constants MuJoCo computes at ``qpos0``: each limited
hinge's spring from the diagonal of ``mj_fullM`` and each contact point's
stiffness and damping from its effective mass (``mj_jac`` and M^-1). It
needs ``mujoco`` and ``gymnasium``, which a host that trains on the card
need not have: nothing on the card's path imports this tool. ``OUT``
defaults to the package's ``envs/rigid3d_models.py``.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np

TASKS = {"Ant-v4": "ant.xml", "Humanoid-v4": "humanoid.xml",
         "HumanoidStandup-v4": "humanoidstandup.xml"}
_FREE, _HINGE, _SPHERE, _CAPSULE = 0, 3, 2, 3  # mjtJoint, mjtGeom
OUT = Path(__file__).resolve().parents[1] / "envs" / "rigid3d_models.py"


def _quat_to_mat(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def extract(env_name: str, xml_file: str, contact_zeta: float = 1.0,
            slip_velocity: float = 0.05, n_substeps: int = 1, max_qvel: float = 100.0) -> dict:
    """The fields of one task's 3D model, as lists and floats."""
    import gymnasium.envs.mujoco as gym_mujoco
    import mujoco

    xml = os.path.join(os.path.dirname(gym_mujoco.__file__), "assets", xml_file)
    m = mujoco.MjModel.from_xml_path(xml)

    body_rot = np.stack([_quat_to_mat(m.body_quat[b]) for b in range(m.nbody)])
    inertia = np.zeros((m.nbody, 3, 3))
    for b in range(m.nbody):
        r = _quat_to_mat(m.body_iquat[b])
        inertia[b] = r @ np.diag(np.asarray(m.body_inertia[b])) @ r.T

    jnt_body, jnt_type, jnt_axis, jnt_anchor, jnt_qposadr, jnt_dofadr = [], [], [], [], [], []
    for j in range(m.njnt):
        t = int(m.jnt_type[j])
        if t == _FREE:
            if j != 0 or int(m.jnt_bodyid[j]) != 1:
                raise ValueError(f"{env_name}: free joint must be root")
        elif t != _HINGE:
            raise ValueError(f"{env_name}: unsupported joint type {t}")
        jnt_body.append(int(m.jnt_bodyid[j]))
        jnt_type.append(t)
        jnt_axis.append(np.asarray(m.jnt_axis[j]))
        jnt_anchor.append(np.asarray(m.jnt_pos[j]))
        jnt_qposadr.append(int(m.jnt_qposadr[j]))
        jnt_dofadr.append(int(m.jnt_dofadr[j]))

    act_dof = [int(m.jnt_dofadr[int(m.actuator_trnid[a, 0])]) for a in range(m.nu)]
    gear = [float(m.actuator_gear[a, 0]) for a in range(m.nu)]

    floor_mu = 0.0
    for g in range(m.ngeom):
        if int(m.geom_bodyid[g]) == 0:
            floor_mu = max(floor_mu, float(m.geom_friction[g][0]))

    cp_body, cp_offset, cp_radius, cp_friction = [], [], [], []
    rg_body, rg_a, rg_b, rg_radius = [], [], [], []
    for g in range(m.ngeom):
        b = int(m.geom_bodyid[g])
        if b == 0:
            continue
        gtype = int(m.geom_type[g])
        pos = np.asarray(m.geom_pos[g])
        mu = max(float(m.geom_friction[g][0]), floor_mu)
        if gtype == _CAPSULE:
            half, r = float(m.geom_size[g][1]), float(m.geom_size[g][0])
            axis = _quat_to_mat(m.geom_quat[g]) @ np.array([0.0, 0.0, 1.0])
            for s in (-1.0, 0.0, 1.0):
                cp_body.append(b)
                cp_offset.append(pos + s * half * axis)
                cp_radius.append(r)
                cp_friction.append(mu)
            rg_body.append(b)
            rg_a.append(pos - half * axis)
            rg_b.append(pos + half * axis)
            rg_radius.append(r)
        elif gtype == _SPHERE:
            cp_body.append(b)
            cp_offset.append(pos)
            cp_radius.append(float(m.geom_size[g][0]))
            cp_friction.append(mu)
            rg_body.append(b)
            rg_a.append(pos)
            rg_b.append(pos)
            rg_radius.append(float(m.geom_size[g][0]))

    dt_sub = float(m.opt.timestep) / n_substeps
    contact_omega = 0.25 / dt_sub
    # the limit springs and the contact constants, from MuJoCo at qpos0
    d0 = mujoco.MjData(m)
    d0.qpos[:] = m.qpos0
    mujoco.mj_forward(m, d0)
    m0 = np.zeros((m.nv, m.nv))
    mujoco.mj_fullM(m, d0, m0)
    omega_lim = 60.0
    limit_k, limit_c = np.zeros(m.njnt), np.zeros(m.njnt)
    for j in range(m.njnt):
        if int(m.jnt_type[j]) == _HINGE:
            mjj = float(m0[m.jnt_dofadr[j], m.jnt_dofadr[j]])
            limit_k[j] = omega_lim**2 * mjj
            limit_c[j] = 2.0 * np.sqrt(limit_k[j] * mjj)
    minv0 = np.linalg.inv(m0)
    cp_k, cp_c = [], []
    for b, off in zip(cp_body, cp_offset):
        world_pt = d0.xpos[b] + d0.xmat[b].reshape(3, 3) @ np.asarray(off)
        jacp, jacr = np.zeros((3, m.nv)), np.zeros((3, m.nv))
        mujoco.mj_jac(m, d0, jacp, jacr, world_pt, b)
        jz = jacp[2]
        m_eff = 1.0 / max(float(jz @ minv0 @ jz), 1e-9)
        kp = m_eff * contact_omega**2
        cp_k.append(kp)
        cp_c.append(2.0 * contact_zeta * np.sqrt(kp * m_eff))

    arr = lambda x: np.asarray(x, np.float64).tolist()  # noqa: E731
    return dict(
        parent=[int(p) for p in m.body_parentid],
        body_pos=arr(m.body_pos), body_rot=arr(body_rot), body_ipos=arr(m.body_ipos),
        mass=arr(m.body_mass), inertia=arr(inertia),
        jnt_body=jnt_body, jnt_type=jnt_type, jnt_axis=arr(jnt_axis),
        jnt_anchor=arr(jnt_anchor), jnt_qposadr=jnt_qposadr, jnt_dofadr=jnt_dofadr,
        qpos0=arr(m.qpos0), jnt_range=arr(m.jnt_range),
        jnt_limited=arr(np.asarray(m.jnt_limited, np.float64)),
        damping=arr(m.dof_damping), armature=arr(m.dof_armature),
        stiffness=arr(m.jnt_stiffness), springref=arr(m.qpos_spring),
        act_dof=act_dof, gear=arr(gear), ctrlrange=arr(m.actuator_ctrlrange),
        cp_body=cp_body, cp_offset=arr(cp_offset), cp_radius=arr(cp_radius),
        cp_friction=arr(cp_friction),
        rg_body=rg_body, rg_a=arr(rg_a), rg_b=arr(rg_b), rg_radius=arr(rg_radius),
        cp_k=arr(cp_k), cp_c=arr(cp_c), limit_k=arr(limit_k), limit_c=arr(limit_c),
        nq=int(m.nq), nv=int(m.nv), dt=float(m.opt.timestep), gravity=float(-m.opt.gravity[2]),
        n_substeps=n_substeps, slip_velocity=slip_velocity, max_qvel=max_qvel,
    )


def render() -> str:
    """The generated module's source."""
    import gymnasium
    import mujoco

    lines = [
        '"""The 3D MuJoCo models\' constants, one dict of fields per task.',
        "",
        "Generated by active_inference_diffusion_torch/tools/extract_rigid3d_models.py",
        f"from the Gymnasium {gymnasium.__version__} MuJoCo XMLs, read with mujoco "
        f"{mujoco.__version__}.",
        "Do not edit: run the tool again. Floats are float64 literals; the engine",
        "casts them to the run's type (envs/rigid3d.py::Rigid3DModel).",
        '"""',
        "",
        "MODELS = {",
    ]
    for name, xml in TASKS.items():
        lines.append(f"    {name!r}: {{")
        for field, value in extract(name, xml).items():
            lines.append(f"        {field!r}: {value!r},")
        lines.append("    },")
    lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out = Path(argv[0]) if argv else OUT
    out.write_text(render())
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
