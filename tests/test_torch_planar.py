"""Port parity: the planar engine (``envs/planar.py``) against the JAX
package's, for HalfCheetah-v4, Hopper-v4 and Walker2d-v4.

- The stored constants (``envs/planar_models.py``, float64) rounded to
  float32 equal ``extract_planar_model(name)``'s float32 arrays exactly.
- ``forward_kinematics``, ``mass_matrix``, ``bias_forces``, ``qacc`` (with
  the Euler models' implicit damping), the penalty model's
  ``contact_forces`` and limit springs, and ``contact_projection`` at batched
  states: the first two envs sunk below the floor with every limited joint
  beyond its range, so every row of the projected Gauss-Seidel is active
  (checked), the other two near the keyframe; one env step (``step_physics``
  of ``frame_skip`` model steps, then the -v4 observation, reward and
  termination) from a state in light contact with a limit violated; a reset
  on the JAX reset's draws.
- The port runs in float64 and in float32. The JAX engine runs in float64
  (x64 on), once from the stored float64 constants and inputs, and once
  from the same numbers rounded to float32: the exact result of the
  float32 configuration, which the port's float32 run is held to.

Tracing the JAX engine costs seconds a task (the nested ``jacfwd`` of
every ``qacc``; compiling is cheaper), so each task's JAX program is
traced once, for one env, with the model's float arrays as arguments, and
called per env and per configuration; one test a task holds both
configurations, so one process traces it. Tolerances: float64 ``F64_TOL``
(rtol 1e-9 / atol 1e-9: another order of the same sums, and closed-form
derivatives against JAX's autodiff); float32 ``F32_TOL``, rtol 2e-4 and
atol 2e-4 plus 1e-5 of the quantity's largest magnitude: float32 rounding
carried through M^-1 of a stiff chain (the Walker's joint accelerations
reach 1.7e3 where some entries are near 10) and through the 8 sweeps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.envs import planar as jplanar
from active_inference_diffusion_torch.envs import planar as tplanar
from active_inference_diffusion_torch.envs.device_envs import ResetDraws
from active_inference_diffusion_torch.envs.planar_models import MODELS

TASKS = ["HalfCheetah-v4", "Hopper-v4", "Walker2d-v4"]
DTYPES = {"float64": torch.float64, "float32": torch.float32}
F64_TOL = dict(rtol=1e-9, atol=1e-9)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
N = 4
_FIELDS = ["body_pos", "body_ipos", "mass", "iyy", "jnt_axis", "jnt_sign", "jnt_anchor",
           "qpos0", "jnt_range", "jnt_limited", "damping", "armature", "stiffness",
           "springref", "gear", "ctrlrange", "geom_a", "geom_b", "geom_radius", "cp_offset",
           "cp_radius", "cp_friction"]
# the fields the JAX program takes as arguments (jnt_limited decides the
# static set of limit rows)
_TRACED = [f for f in _FIELDS if f != "jnt_limited"]


@pytest.fixture(scope="module", autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def states(name):
    """(qpos, qvel, ctrl) at the projection's states and (qpos, qvel) at the
    env step's, as float64 numpy."""
    raw = MODELS[name]
    nj = len(raw["jnt_body"])
    lo, hi = np.asarray(raw["jnt_range"]).T
    limited = np.asarray(raw["jnt_limited"]) > 0
    rng = np.random.default_rng(sum(map(ord, name)))
    qpos = np.asarray(raw["qpos0"]) + rng.uniform(-0.1, 0.1, (N, nj))
    qpos[:2, 1] -= 5.0  # every contact point below the floor
    past = np.where(np.arange(nj) % 2 == 0, hi + 0.05, lo - 0.05)
    qpos[:2] = np.where(limited, past, qpos[:2])
    qvel = rng.uniform(-1.0, 1.0, (N, nj))
    ctrl = rng.uniform(-1.3, 1.3, (N, len(raw["act_dof"])))
    step_qpos = np.asarray(raw["qpos0"]) + rng.uniform(-0.02, 0.02, (N, nj))
    step_qpos[:, 1] -= 0.03  # light contact
    j = int(np.flatnonzero(limited)[0])
    step_qpos[0, j] = hi[j] + 0.02
    step_qvel = rng.uniform(-0.5, 0.5, (N, nj))
    return qpos, qvel, ctrl, step_qpos, step_qvel


def rounded(x, dtype):
    """float64 numpy of ``x`` rounded to ``dtype``."""
    return np.asarray(np.asarray(x, np.float64).astype(
        np.float32 if dtype == "float32" else np.float64), np.float64)


@functools.lru_cache(maxsize=None)
def jax_program(name):
    """The task's JAX program for one env: (float fields, qpos, qvel, ctrl,
    step qpos, step qvel, reset key) -> every compared quantity. Traced
    and compiled once, at float64."""
    env = jplanar.PlanarMJCEnv(name)
    base = env.model._replace(jnt_limited=jnp.asarray(np.asarray(MODELS[name]["jnt_limited"])))
    h = base.dt / base.n_substeps
    damp = 0.0 if base.use_rk4 else h

    def program(fields, qpos, qvel, ctrl, step_qpos, step_qvel, key):
        model = base._replace(**dict(zip(_TRACED, fields)))
        env.model = model
        pos, th = jplanar.forward_kinematics(model, qpos)
        reset = env.reset(key)
        stepped = env.step(reset.replace(physics=jnp.concatenate([step_qpos, step_qvel])), ctrl)
        return dict(
            pos=pos, theta=th, mass=jplanar.mass_matrix(model, qpos),
            bias=jplanar.bias_forces(model, qpos, qvel),
            qacc=jplanar.qacc(model, qpos, qvel, ctrl, damp),
            projection=jplanar.contact_projection(model, qpos, qvel, h),
            penalty_contact=jplanar.contact_forces(model, qpos, qvel),
            penalty_passive=jplanar.passive_and_limit_forces(
                model._replace(contact_model="penalty"), qpos, qvel),
            reset_physics=reset.physics, reset_obs=reset.obs,
            step_physics=stepped.physics, step_obs=stepped.obs, step_reward=stepped.reward,
            step_terminated=stepped.terminated, step_done=stepped.done,
        )

    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(program).lower(*args).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return compiled[0](*args)

    return call


@functools.lru_cache(maxsize=None)
def jax_results(name, dtype):
    """Every compared quantity per env, stacked, from the task's program on
    the constants and inputs rounded to ``dtype``; and the reset's draws."""
    raw = MODELS[name]
    fields = tuple(jnp.asarray(rounded(raw[f], dtype)) for f in _TRACED)
    inputs = [rounded(x, dtype) for x in states(name)]
    keys = jax.random.split(jax.random.PRNGKey(5), N)
    call = jax_program(name)
    rows = [call(fields, *(jnp.asarray(x[i]) for x in inputs), keys[i]) for i in range(N)]
    out = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    # the reset's draws: the reset key's first half splits in (qpos, qvel)
    nq = len(raw["jnt_body"])
    draws = []
    for key in keys:
        kq, kv = jax.random.split(jax.random.split(key)[0])
        uq = np.asarray(jax.random.uniform(kq, (nq,), jnp.float64))
        if name == "HalfCheetah-v4":  # normal qvel noise
            draws.append((uq, np.asarray(jax.random.normal(kv, (nq,), jnp.float64))))
        else:
            draws.append((np.concatenate([uq, np.asarray(jax.random.uniform(
                kv, (nq,), jnp.float64))]), None))
    normal = None if draws[0][1] is None else np.stack([d[1] for d in draws])
    out["reset_draws"] = (np.stack([d[0] for d in draws]), normal)
    return out


def tol_for(dtype, want):
    if dtype == "float64":
        return F64_TOL
    return dict(rtol=F32_TOL["rtol"],
                atol=F32_TOL["atol"] + 1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", TASKS)
def test_stored_constants_match_extract_planar_model(name):
    jm = jplanar.extract_planar_model(name)
    raw = MODELS[name]
    for field in _FIELDS:
        np.testing.assert_array_equal(np.asarray(raw[field], np.float32),
                                      np.asarray(getattr(jm, field)), err_msg=field)
    for field in ("parent", "jnt_body", "jnt_type", "geom_body"):
        assert tuple(raw[field]) == tuple(getattr(jm, field)), field
    for field in ("act_dof", "cp_body"):
        np.testing.assert_array_equal(raw[field], np.asarray(getattr(jm, field)), err_msg=field)
    assert (raw["dt"], raw["gravity"], raw["use_rk4"], raw["n_substeps"]) == (
        jm.dt, jm.gravity, jm.use_rk4, jm.n_substeps)


@pytest.mark.parametrize("name", TASKS)
def test_planar_engine_matches_jax(name):
    for dtype in DTYPES:
        check_engine(name, dtype)


def check_engine(name, dtype):
    tdtype = DTYPES[dtype]
    want = jax_results(name, dtype)
    env = tplanar.PlanarMJCEnv(name, device="cpu", dtype=tdtype)
    model = env.model
    qpos, qvel, ctrl, step_qpos, step_qvel = (torch.tensor(x, dtype=tdtype) for x in states(name))
    h = model.dt / model.n_substeps

    def check(got, key):
        np.testing.assert_allclose(got.numpy(), want[key], err_msg=f"{name} {dtype} {key}",
                                   **tol_for(dtype, want[key]))

    # every PGS row active in the first two envs: all points in the floor, every limit violated
    points = tplanar._contact_points(model, qpos)
    assert (model.cp_radius - points[:2, :, 1] > 0).all()
    lim = model.limited
    lo, hi = model.jnt_range[lim, 0], model.jnt_range[lim, 1]
    assert ((qpos[:2, lim] < lo) | (qpos[:2, lim] > hi)).all()

    pos, theta = tplanar.forward_kinematics(model, qpos)
    check(pos, "pos")
    check(theta, "theta")
    check(tplanar.mass_matrix(model, qpos), "mass")
    check(tplanar.bias_forces(model, qpos, qvel), "bias")
    check(tplanar.qacc(model, qpos, qvel, ctrl, 0.0 if model.use_rk4 else h), "qacc")
    check(tplanar.contact_forces(model, qpos, qvel), "penalty_contact")
    penalty = tplanar.PlanarModel(name, "cpu", tdtype, contact_model="penalty")
    check(tplanar.passive_and_limit_forces(penalty, qpos, qvel), "penalty_passive")
    projected = tplanar.contact_projection(model, qpos, qvel, h)
    check(projected, "projection")
    assert not torch.allclose(projected, qvel)

    uniform, normal = want["reset_draws"]
    reset = env.reset(ResetDraws(torch.tensor(uniform, dtype=tdtype),
                                 None if normal is None else torch.tensor(normal, dtype=tdtype)))
    check(reset.physics, "reset_physics")
    check(reset.obs, "reset_obs")
    state = reset.replace(physics=torch.cat([step_qpos, step_qvel], dim=1))
    stepped = env.step(state, ctrl)
    for field in ("physics", "obs", "reward"):
        check(getattr(stepped, field), f"step_{field}")
    for field in ("terminated", "done"):
        np.testing.assert_array_equal(getattr(stepped, field).numpy(), want[f"step_{field}"])
    assert (stepped.step_count == 1).all()
