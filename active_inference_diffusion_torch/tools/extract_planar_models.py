"""Write ``envs/planar_models.py``: the planar models' constants as literals.

    python active_inference_diffusion_torch/tools/extract_planar_models.py

Reads the Gymnasium MuJoCo XMLs of HalfCheetah-v4, Hopper-v4 and
Walker2d-v4 through the host ``mujoco`` binding, as the JAX package's
``envs/planar.py::extract_planar_model`` (:141-330) does, and writes each
task's fields as float64 (and integer) literals: body tree, masses, the
body-frame yy inertia (the principal inertia rotated back from the
inertial frame), joints, actuators, capsule geoms, contact candidate points
(capsule ends and centre, sphere centres) with the floor's friction folded
in, timestep, gravity and integrator. The penalty-contact constants are not
read from the XML: ``PlanarModel`` takes them, with the same defaults. It
needs ``mujoco`` and ``gymnasium``, which a host that trains on the card
need not have: nothing on the card's path imports this tool.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

TASKS = {"HalfCheetah-v4": "half_cheetah.xml", "Hopper-v4": "hopper.xml",
         "Walker2d-v4": "walker2d.xml"}
_SLIDE, _HINGE, _SPHERE, _CAPSULE = 2, 3, 2, 3  # mjtJoint, mjtGeom
OUT = Path(__file__).resolve().parents[1] / "envs" / "planar_models.py"


def _quat_to_mat(q) -> np.ndarray:
    w, x, y, z = (float(v) for v in q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _quat_y_angle(q) -> float:
    return 2.0 * float(np.arctan2(q[2], q[0]))


def extract(env_name: str, xml_file: str) -> dict:
    """The fields of one task's planar model, as lists and floats."""
    import gymnasium.envs.mujoco as gym_mujoco
    import mujoco

    xml = os.path.join(os.path.dirname(gym_mujoco.__file__), "assets", xml_file)
    m = mujoco.MjModel.from_xml_path(xml)
    for b in range(m.nbody):
        if abs(_quat_y_angle(m.body_quat[b])) > 1e-9:
            raise ValueError(f"{env_name}: non-identity body quat on body {b}")

    jnt_body, jnt_type, jnt_axis, jnt_sign, jnt_anchor = [], [], [], [], []
    for j in range(m.njnt):
        t = int(m.jnt_type[j])
        ax = np.asarray(m.jnt_axis[j])
        if t == _SLIDE:
            if abs(ax[1]) > 1e-9:
                raise ValueError(f"{env_name}: out-of-plane slide joint {j}")
            jnt_axis.append(ax[[0, 2]])
            jnt_sign.append(0.0)
        elif t == _HINGE:
            if abs(ax[0]) > 1e-9 or abs(ax[2]) > 1e-9:
                raise ValueError(f"{env_name}: non-y hinge joint {j}")
            jnt_axis.append(np.zeros(2))
            jnt_sign.append(float(ax[1]))
        else:
            raise ValueError(f"{env_name}: unsupported joint type {t}")
        jnt_body.append(int(m.jnt_bodyid[j]))
        jnt_type.append(t)
        jnt_anchor.append(np.asarray(m.jnt_pos[j])[[0, 2]])

    act_dof = [int(m.jnt_dofadr[int(m.actuator_trnid[a, 0])]) for a in range(m.nu)]
    gear = [float(m.actuator_gear[a, 0]) for a in range(m.nu)]

    # contact friction is the element-wise max of the two geoms' (equal priorities)
    floor_mu = 0.0
    for g in range(m.ngeom):
        if int(m.geom_bodyid[g]) == 0:
            floor_mu = max(floor_mu, float(m.geom_friction[g][0]))

    geom_body, geom_a, geom_b, geom_radius = [], [], [], []
    cp_body, cp_offset, cp_radius, cp_friction = [], [], [], []
    for g in range(m.ngeom):
        b = int(m.geom_bodyid[g])
        if b == 0:
            continue
        gtype = int(m.geom_type[g])
        pos = np.asarray(m.geom_pos[g])[[0, 2]]
        mu = max(float(m.geom_friction[g][0]), floor_mu)
        if gtype == _CAPSULE:
            half, r = float(m.geom_size[g][1]), float(m.geom_size[g][0])
            ang = _quat_y_angle(m.geom_quat[g])
            axis = np.array([np.sin(ang), np.cos(ang)])
            geom_body.append(b)
            geom_a.append(pos - half * axis)
            geom_b.append(pos + half * axis)
            geom_radius.append(r)
            for s in (-1.0, 0.0, 1.0):
                cp_body.append(b)
                cp_offset.append(pos + s * half * axis)
                cp_radius.append(r)
                cp_friction.append(mu)
        elif gtype == _SPHERE:
            r = float(m.geom_size[g][0])
            geom_body.append(b)
            geom_a.append(pos)
            geom_b.append(pos)
            geom_radius.append(r)
            cp_body.append(b)
            cp_offset.append(pos)
            cp_radius.append(r)
            cp_friction.append(mu)

    use_rk4 = int(m.opt.integrator) == 1  # mjINT_RK4
    dofs = [int(m.jnt_dofadr[j]) for j in range(m.njnt)]
    iyy = [float(np.sum(np.asarray(m.body_inertia[b]) * _quat_to_mat(m.body_iquat[b])[1, :] ** 2))
           for b in range(m.nbody)]
    arr = lambda x: np.asarray(x, np.float64).tolist()  # noqa: E731
    return dict(
        parent=[int(p) for p in m.body_parentid],
        body_pos=arr(np.asarray(m.body_pos)[:, [0, 2]]),
        body_ipos=arr(np.asarray(m.body_ipos)[:, [0, 2]]),
        mass=arr(m.body_mass), iyy=arr(iyy),
        jnt_body=jnt_body, jnt_type=jnt_type, jnt_axis=arr(jnt_axis), jnt_sign=arr(jnt_sign),
        jnt_anchor=arr(jnt_anchor), qpos0=arr(m.qpos0), jnt_range=arr(m.jnt_range),
        jnt_limited=arr(np.asarray(m.jnt_limited, np.float64)),
        damping=arr(np.asarray(m.dof_damping)[dofs]),
        armature=arr(np.asarray(m.dof_armature)[dofs]),
        stiffness=arr(m.jnt_stiffness), springref=arr(m.qpos_spring),
        act_dof=act_dof, gear=arr(gear), ctrlrange=arr(m.actuator_ctrlrange),
        geom_body=geom_body, geom_a=arr(geom_a), geom_b=arr(geom_b),
        geom_radius=arr(geom_radius),
        cp_body=cp_body, cp_offset=arr(cp_offset), cp_radius=arr(cp_radius),
        cp_friction=arr(cp_friction),
        dt=float(m.opt.timestep), gravity=float(-m.opt.gravity[2]), use_rk4=use_rk4,
        # Euler models (HalfCheetah, dt 0.01) integrate in 5 substeps a model step
        n_substeps=1 if use_rk4 else 5,
    )


def main() -> None:
    import gymnasium
    import mujoco

    lines = [
        '"""The planar MuJoCo models\' constants, one dict of fields per task.',
        "",
        "Generated by active_inference_diffusion_torch/tools/extract_planar_models.py",
        f"from the Gymnasium {gymnasium.__version__} MuJoCo XMLs, read with mujoco "
        f"{mujoco.__version__}.",
        "Do not edit: run the tool again. Floats are float64 literals; the engine",
        "casts them to the run's type (envs/planar.py::PlanarModel).",
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
    OUT.write_text("\n".join(lines) + "\n")
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
