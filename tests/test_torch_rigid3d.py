"""Port parity: the 3D engine (``envs/rigid3d.py``) against the JAX
package's, for the Ant tree (Ant-v4) and the Humanoid tree (Humanoid-v4 and
HumanoidStandup-v4, one static structure).

- The stored constants (``envs/rigid3d_models.py``, float64) rounded to
  float32 equal ``extract_rigid3d_model(name)``'s float32 arrays exactly,
  the static fields are equal, and the tool that wrote the module writes
  it again unchanged.
- ``forward_kinematics``, ``mass_matrix``, ``bias_forces``,
  ``contact_forces``, ``contact_wrenches``, ``com_frame_fields``,
  ``passive_and_limit_forces``, ``applied_torques``, ``qacc`` and
  ``limit_projection`` at batched states: the first two envs sunk below the
  floor with every limited hinge beyond its range, so every row of the
  projected Gauss-Seidel is active (checked), the other two near
  ``qpos0``; one ``step_physics`` of ``frame_skip`` model steps and one env
  step (observation, reward, termination) from states in light contact
  with a limit violated; a reset on the JAX reset's draws; ``quat_exp``
  just below and just above its series threshold.
- The port runs in float64 and in float32. The JAX engine runs in float64
  (x64 on), once from the stored float64 constants and inputs, and once
  from the same numbers rounded to float32: the exact result of the
  float32 configuration, which the port's float32 run is held to.

Tracing the JAX engine is its cost (nested ``jacfwd``, ``jvp`` and
``grad`` of the forward kinematics), and tracing JAX's ``step_physics``
costs minutes a tree. So each tree traces the pieces above and the limit
projection once, for one env at one state, with the model's float arrays
as arguments, as three programs compiled side by side in threads
(``jax_program``). They are compiled at XLA optimisation level 0
and called per env, per configuration and per stage: ``qacc`` is held
against a float64 solve of JAX's own M and forces (``rigid3d.py:669-682``),
and the env step against a reference assembled from JAX's functions in the
order of ``rigid3d.py:771-799`` (the program's pieces per RK4 stage, JAX's
``integrate_pos`` and ``limit_projection``, the ``max_qvel`` clip), then
JAX's -v4 task functions on the program's fields before and after. The
Ant and the Humanoid trees are separate tests, so xdist can run them on
separate workers. The module turns JAX's persistent compilation cache off
for its programs (its huge CPU executables have crashed jaxlib's cache
write): JAX decides once per process whether it uses the cache, so the
setting alone would not reach a worker that compiled before; the cache
state is reset on entry and on leaving.

Tolerances: float64 ``F64_TOL`` (rtol 1e-9 / atol 1e-9: another order of
the same sums, and closed-form derivatives against JAX's autodiff);
float32 ``F32_TOL``, rtol 2e-4 and atol 2e-4 plus 1e-5 of the quantity's
largest magnitude: float32 rounding carried through M^-1 of a stiff tree,
the penalty contacts and the 8 sweeps, as for the planar engine.
"""

import argparse
import functools
import importlib.util
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import compilation_cache

from active_inference_diffusion_tpu.configs.config import config_to_dict
from active_inference_diffusion_tpu.envs import mujoco_tasks as jtasks
from active_inference_diffusion_tpu.envs import rigid3d as jrigid
from active_inference_diffusion_torch import train_fused
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.envs import rigid3d as trigid
from active_inference_diffusion_torch.envs.device_envs import ResetDraws
from active_inference_diffusion_torch.envs.rigid3d_models import MODELS

TREES = {"Ant": ("Ant-v4",), "Humanoid": ("Humanoid-v4", "HumanoidStandup-v4")}
DTYPES = {"float64": torch.float64, "float32": torch.float32}
F64_TOL = dict(rtol=1e-9, atol=1e-9)
F32_TOL = dict(rtol=2e-4, atol=2e-4)
N = 4
_FIELDS = ["body_pos", "body_rot", "body_ipos", "mass", "inertia", "jnt_axis", "jnt_anchor",
           "qpos0", "jnt_range", "jnt_limited", "damping", "armature", "stiffness", "springref",
           "gear", "ctrlrange", "cp_offset", "cp_radius", "cp_friction", "rg_a", "rg_b",
           "rg_radius", "cp_k", "cp_c", "limit_k", "limit_c"]
# the fields the JAX program takes as arguments (jnt_limited decides the
# static set of limit rows; the render geoms are not read by the physics)
_TRACED = [f for f in _FIELDS if f not in ("jnt_limited", "rg_a", "rg_b", "rg_radius")]
_STATIC = ["parent", "jnt_body", "jnt_type", "jnt_qposadr", "jnt_dofadr", "act_dof", "cp_body",
           "rg_body", "nq", "nv", "dt", "gravity", "n_substeps", "slip_velocity", "max_qvel"]
_CFRAME = ("cinert", "cvel", "qfrc_actuator", "cfrc_ext", "xipos")


@pytest.fixture(scope="module", autouse=True)
def _x64_without_persistent_cache():
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", enabled)
    compilation_cache.reset_cache()
    jax.config.update("jax_enable_x64", False)


def rounded(x, dtype):
    """float64 numpy of ``x`` rounded to ``dtype``."""
    return np.asarray(np.asarray(x, np.float64).astype(
        np.float32 if dtype == "float32" else np.float64), np.float64)


def tol_for(dtype, want):
    if dtype == "float64":
        return F64_TOL
    return dict(rtol=F32_TOL["rtol"],
                atol=F32_TOL["atol"] + 1e-5 * float(np.abs(want).max()))


def _unit(q):
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _lowest_point(name, qpos):
    """The lowest contact point's height less its radius at each state."""
    model = trigid.Rigid3DModel(name, "cpu", torch.float64)
    kin = trigid._kinematics(model, torch.tensor(qpos))
    points = trigid._attached(kin, model.cp_body_idx, model.cp_offset)
    return (points[..., 2] - model.cp_radius).min(dim=1).values.numpy()


def states(name):
    """(qpos, qvel, ctrl) at the pieces' states and (qpos, qvel) at the env
    step's, as float64 numpy."""
    raw = MODELS[name]
    nq, nv, nu = raw["nq"], raw["nv"], len(raw["act_dof"])
    lo, hi = np.asarray(raw["jnt_range"])[1:].T
    limited = np.asarray(raw["jnt_limited"])[1:] > 0
    qpos0 = np.asarray(raw["qpos0"])
    rng = np.random.default_rng(sum(map(ord, name)))
    qpos = qpos0 + rng.uniform(-0.1, 0.1, (N, nq))
    qpos[:, 3:7] = _unit(qpos0[3:7] + rng.normal(0.0, 0.3, (N, 4)))
    qpos[:2, 2] -= 5.0  # every contact point below the floor
    past = np.where(np.arange(nq - 7) % 2 == 0, hi + 0.05, lo - 0.05)
    qpos[:2, 7:] = np.where(limited, past, qpos[:2, 7:])
    qvel = rng.uniform(-1.0, 1.0, (N, nv))
    ctrl = rng.uniform(-1.3, 1.3, (N, nu)) * np.abs(np.asarray(raw["ctrlrange"])[:, 1])
    step_qpos = qpos0 + rng.uniform(-0.02, 0.02, (N, nq))
    step_qpos[:, 3:7] = _unit(qpos0[3:7] + rng.normal(0.0, 0.02, (N, 4)))
    step_qpos[:, 2] -= _lowest_point(name, step_qpos) + 0.01  # light contact
    j = int(np.flatnonzero(limited)[0])
    step_qpos[0, 7 + j] = hi[j] + 0.02
    step_qvel = rng.uniform(-0.5, 0.5, (N, nv))
    return qpos, qvel, ctrl, step_qpos, step_qvel


@functools.lru_cache(maxsize=None)
def jax_program(tree):
    """The tree's JAX program for one env: (float fields, qpos, qvel, ctrl)
    -> the pieces and the limit projection, as three programs (``bias_forces``,
    ``com_frame_fields``, the rest). Traced once, at float64, each in
    turn, the costliest first, and each compiled in a thread of its own as
    soon as it is lowered (XLA compiles without Python's lock), so the
    later traces run beside the earlier compiles."""
    name = TREES[tree][0]
    base = jrigid.extract_rigid3d_model(name)._replace(
        jnt_limited=np.asarray(MODELS[name]["jnt_limited"]))
    h = base.dt / base.n_substeps

    def model(fields):
        return base._replace(**dict(zip(_TRACED, fields)))

    def rest(fields, qpos, qvel, ctrl):
        m = model(fields)
        pos, rot = jrigid.forward_kinematics(m, qpos)
        return dict(
            pos=pos, rot=rot, mass=jrigid.mass_matrix(m, qpos),
            contact=jrigid.contact_forces(m, qpos, qvel),
            passive=jrigid.passive_and_limit_forces(m, qpos, qvel),
            applied=jrigid.applied_torques(m, ctrl),
            projection=jrigid.limit_projection(m, qpos, qvel, h),
        )

    programs = (
        lambda fields, qpos, qvel, ctrl: dict(bias=jrigid.bias_forces(model(fields), qpos, qvel)),
        lambda fields, qpos, qvel, ctrl: jrigid.com_frame_fields(model(fields), qpos, qvel, ctrl),
        rest,
    )
    compiled = []

    def call(*args):
        if not compiled:
            with ThreadPoolExecutor(len(programs)) as pool:
                futures = [pool.submit(jax.jit(program).lower(*args).compile,
                                       compiler_options={"xla_backend_optimization_level": 0})
                           for program in programs]
            compiled.extend(f.result() for f in futures)
        return {k: np.asarray(v) for program in compiled for k, v in program(*args).items()}

    return call


_integrate = jax.jit(lambda q, v, dt: jrigid.integrate_pos(None, q, v, dt))


def jax_qacc(piece):
    """``qacc`` from JAX's own pieces, as ``rigid3d.py:675-682`` combines them."""
    rhs = piece["applied"] + piece["passive"] + piece["contact"] - piece["bias"]
    return np.linalg.solve(piece["mass"], rhs)


def jax_fields(call, fields, name, qpos, qvel, ctrl):
    """JAX ``Rigid3DEnv._fields`` from the program's pieces."""
    spec = jtasks.TASK_SPECS[name]
    p = call(fields, qpos, qvel, ctrl)
    cf = {k: p[k] for k in _CFRAME} if spec.full_body_obs or spec.standup else {}
    return jtasks.MjPhysicsFields(qpos=qpos, qvel=qvel, torso_xpos=p["pos"][1], **cf)


def jax_task(call, fields, name, before, qpos, qvel, ctrl):
    """``Rigid3DEnv.step``'s task semantics after the physics: the
    observation, reward and termination at (qpos, qvel), the step having
    started from the fields ``before``."""
    raw = MODELS[name]
    spec = jtasks.TASK_SPECS[name]
    after = jax_fields(call, fields, name, qpos, qvel, ctrl)
    reward = jtasks.task_reward(spec, before, after, ctrl, raw["dt"] * spec.frame_skip,
                                body_mass=fields[_TRACED.index("mass")],
                                model_timestep=raw["dt"])
    return (np.asarray(jtasks.task_observation(spec, after)), float(reward),
            bool(jtasks.task_terminated(spec, qpos, qvel)))


def jax_step(call, fields, name, qpos, qvel, ctrl):
    """One env step of ``name`` assembled from JAX's functions
    (``rigid3d.py:771-799`` per substep, then ``Rigid3DEnv.step``'s task
    semantics). Returns (physics, obs, reward, terminated)."""
    raw = MODELS[name]
    h = raw["dt"] / raw["n_substeps"]

    def acc(q, v):
        return jax_qacc(call(fields, q, v, ctrl))

    def integ(q, v, dt):
        return np.asarray(_integrate(q, v, dt))

    before = jax_fields(call, fields, name, qpos, qvel, ctrl)
    q, qd = qpos, qvel
    for _ in range(jtasks.TASK_SPECS[name].frame_skip * raw["n_substeps"]):
        k1 = acc(q, qd)
        k2 = acc(integ(q, qd, 0.5 * h), qd + 0.5 * h * k1)
        k3 = acc(integ(q, qd + 0.5 * h * k1, 0.5 * h), qd + 0.5 * h * k2)
        k4 = acc(integ(q, qd + 0.5 * h * k2, h), qd + h * k3)
        vel_mean = (qd + 2.0 * (qd + 0.5 * h * k1) + 2.0 * (qd + 0.5 * h * k2)
                    + (qd + h * k3)) / 6.0
        q_new = integ(q, vel_mean, h)
        qd_new = qd + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        qd_new = call(fields, q_new, qd_new, ctrl)["projection"]
        q, qd = q_new, np.clip(qd_new, -raw["max_qvel"], raw["max_qvel"])
    return (np.concatenate([q, qd]),) + jax_task(call, fields, name, before, q, qd, ctrl)


def jax_reset(call, fields, name, key):
    """JAX ``Rigid3DEnv.reset`` on ``key``: its draws, physics and
    observation."""
    raw = MODELS[name]
    spec = jtasks.TASK_SPECS[name]
    nq, nv = raw["nq"], raw["nv"]
    noise_key, _ = jax.random.split(key)
    qpos0 = fields[_TRACED.index("qpos0")]
    qpos, qvel = jtasks.reset_qpos_qvel(spec, noise_key, qpos0, jnp.zeros((nv,)))
    qpos = np.concatenate([qpos[0:3], jrigid.quat_normalize(qpos[3:7]), qpos[7:]])
    p = call(fields, qpos, np.asarray(qvel), np.zeros(len(raw["act_dof"])))
    cf = {k: p[k] for k in _CFRAME} if spec.full_body_obs or spec.standup else {}
    obs = jtasks.task_observation(spec, jtasks.MjPhysicsFields(
        qpos=qpos, qvel=qvel, torso_xpos=p["pos"][1], **cf))
    kq, kv = jax.random.split(noise_key)
    uq = np.asarray(jax.random.uniform(kq, (nq,), jnp.float64))
    if spec.qvel_noise == "normal":
        draws = (uq, np.asarray(jax.random.normal(kv, (nv,), jnp.float64)))
    else:
        draws = (np.concatenate([uq, np.asarray(jax.random.uniform(kv, (nv,), jnp.float64))]),
                 None)
    return draws, np.concatenate([qpos, np.asarray(qvel)]), np.asarray(obs)


def jax_results(tree, name, dtype):
    """Every compared quantity per env, stacked, from the tree's program on
    ``name``'s constants and inputs rounded to ``dtype``."""
    raw = MODELS[name]
    call = jax_program(tree)
    fields = tuple(jnp.asarray(rounded(raw[f], dtype)) for f in _TRACED)
    qpos, qvel, ctrl, step_qpos, step_qvel = (rounded(x, dtype) for x in states(name))
    rows = [call(fields, qpos[i], qvel[i], ctrl[i]) for i in range(N)]
    out = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    out["qacc"] = np.stack([jax_qacc(r) for r in rows])
    steps = [jax_step(call, fields, name, step_qpos[i], step_qvel[i], ctrl[i])
             for i in range(N)]
    for i, key in enumerate(("step_physics", "step_obs", "step_reward", "step_terminated")):
        out[key] = np.stack([s[i] for s in steps])
    resets = [jax_reset(call, fields, name, key)
              for key in jax.random.split(jax.random.PRNGKey(5), N)]
    uniform = np.stack([r[0][0] for r in resets])
    normal = None if resets[0][0][1] is None else np.stack([r[0][1] for r in resets])
    out["reset_draws"] = (uniform, normal)
    out["reset_physics"] = np.stack([r[1] for r in resets])
    out["reset_obs"] = np.stack([r[2] for r in resets])
    return out


def check_engine(tree, name, dtype):
    tdtype = DTYPES[dtype]
    want = jax_results(tree, name, dtype)
    env = trigid.Rigid3DEnv(name, device="cpu", dtype=tdtype)
    model = env.model
    qpos, qvel, ctrl, step_qpos, step_qvel = (torch.tensor(x, dtype=tdtype)
                                              for x in states(name))
    h = model.dt / model.n_substeps

    def check(got, key):
        np.testing.assert_allclose(got.numpy(), want[key], err_msg=f"{name} {dtype} {key}",
                                   **tol_for(dtype, want[key]))

    # every PGS row active in the first two envs: all points in the floor, every limit violated
    kin = trigid._kinematics(model, qpos)
    points = trigid._attached(kin, model.cp_body_idx, model.cp_offset)
    assert (model.cp_radius - points[:2, :, 2] > 0).all()
    lo, hi = model.jnt_range[model.lim_idx, 0], model.jnt_range[model.lim_idx, 1]
    q_lim = qpos[:2, model.lim_qadr]
    assert len(model.limited) == int(MODELS[name]["jnt_limited"].count(1.0))
    assert ((q_lim < lo) | (q_lim > hi)).all()

    pos, rot = trigid.forward_kinematics(model, qpos)
    check(pos, "pos")
    check(rot, "rot")
    check(trigid.mass_matrix(model, qpos), "mass")
    check(trigid.bias_forces(model, qpos, qvel), "bias")
    check(trigid.contact_forces(model, qpos, qvel), "contact")
    check(trigid.passive_and_limit_forces(model, qpos, qvel), "passive")
    check(trigid.applied_torques(model, ctrl), "applied")
    check(trigid.qacc(model, qpos, qvel, ctrl), "qacc")
    cf = trigid.com_frame_fields(model, qpos, qvel, ctrl)
    for key in _CFRAME:
        check(cf[key], key)
    subtree_com = torch.einsum("b,nbi->ni", model.mass, cf["xipos"]) / model.mass.sum()
    check(trigid.contact_wrenches(model, qpos, qvel, subtree_com), "cfrc_ext")
    coms, rot_b, w_world, _ = trigid.body_velocities(model, qpos, qvel)
    check(coms, "xipos")
    check(rot_b, "rot")
    np.testing.assert_allclose(w_world.numpy(), want["cvel"][..., :3],
                               **tol_for(dtype, want["cvel"]))
    projected = trigid.limit_projection(model, qpos, qvel, h)
    check(projected, "projection")
    assert not torch.allclose(projected[:2], qvel[:2])

    uniform, normal = want["reset_draws"]
    reset = env.reset(ResetDraws(torch.tensor(uniform, dtype=tdtype),
                                 None if normal is None else torch.tensor(normal, dtype=tdtype)))
    check(reset.physics, "reset_physics")
    check(reset.obs, "reset_obs")
    state = reset.replace(physics=torch.cat([step_qpos, step_qvel], dim=1))
    stepped = env.step(state, ctrl)
    check(stepped.physics, "step_physics")
    if dtype == "float32":
        # the task semantics at the port's own float32 state: the penalty
        # contacts' stiffness (cp_k up to 2.7e5 N/m) turns the state's float32
        # rounding after five substeps into ~1e-3 of cfrc_ext (Humanoid's
        # observation, HumanoidStandup's impact cost)
        want = dict(want)
        call = jax_program(tree)
        fields = tuple(jnp.asarray(rounded(MODELS[name][f], dtype)) for f in _TRACED)
        nq = model.nq
        task = []
        for i in range(N):
            q0, v0, c0 = (rounded(x[i], dtype) for x in (step_qpos, step_qvel, ctrl))
            before = jax_fields(call, fields, name, q0, v0, c0)
            after = rounded(stepped.physics[i].numpy(), dtype)
            task.append(jax_task(call, fields, name, before, after[:nq], after[nq:], c0))
        for k, key in enumerate(("step_obs", "step_reward", "step_terminated")):
            want[key] = np.stack([t[k] for t in task])
    check(stepped.obs, "step_obs")
    check(stepped.reward, "step_reward")
    np.testing.assert_array_equal(stepped.terminated.numpy(), want["step_terminated"])
    assert (stepped.step_count == 1).all()


@pytest.mark.parametrize("name", [n for names in TREES.values() for n in names])
def test_stored_constants_match_extract_rigid3d_model(name):
    jm = jrigid.extract_rigid3d_model(name)
    raw = MODELS[name]
    for field in _FIELDS:
        np.testing.assert_array_equal(np.asarray(raw[field], np.float32),
                                      np.asarray(getattr(jm, field)), err_msg=field)
    for field in _STATIC:
        got = getattr(jm, field)
        got = tuple(np.asarray(got).tolist()) if hasattr(got, "shape") else got
        want = tuple(raw[field]) if isinstance(raw[field], list) else raw[field]
        assert want == got, field
    assert jm.limit_model == "constraint"


def test_extract_tool_rewrites_the_stored_module(tmp_path):
    from active_inference_diffusion_torch.tools import extract_rigid3d_models as tool

    out = tmp_path / "rigid3d_models.py"
    tool.main([str(out)])
    assert out.read_text() == tool.OUT.read_text()


@pytest.mark.parametrize("dtype", DTYPES)
def test_quat_exp_at_its_series_threshold(dtype):
    """Rotation vectors whose squared angle lies just below and just above
    1e-16 (the series branch and the sine branch), and a large one; JAX in
    the same type."""
    direction = np.array([0.6, -0.48, 0.64])
    v = np.stack([direction * np.sqrt(s) for s in (0.9e-16, 1.1e-16, 1e-20, 0.7)])
    npdtype = np.float32 if dtype == "float32" else np.float64
    want = np.stack([np.asarray(jrigid.quat_exp(jnp.asarray(x, npdtype))) for x in v])
    got = trigid.quat_exp(torch.tensor(v.astype(npdtype)))
    rtol = 1e-6 if dtype == "float32" else 1e-15
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)
    assert got.dtype == DTYPES[dtype]


def test_rigid3d_engine_matches_jax_ant():
    for dtype in DTYPES:
        check_engine("Ant", "Ant-v4", dtype)


def test_rigid3d_engine_matches_jax_humanoid():
    humanoid, standup = (MODELS[n] for n in TREES["Humanoid"])
    for field in ("parent", "jnt_body", "jnt_type", "jnt_qposadr", "jnt_dofadr", "act_dof",
                  "cp_body", "jnt_limited", "nq", "nv", "dt", "n_substeps"):
        assert humanoid[field] == standup[field], field
    for name in TREES["Humanoid"]:
        for dtype in DTYPES:
            check_engine("Humanoid", name, dtype)


# -- the slice as a whole, on the CPU (no JAX trace) --------------------------

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_train_fused_example",
                                               ROOT / "examples" / "train_fused.py")
jax_train_fused = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_train_fused)


def test_train_fused_iteration_on_ant3d_on_the_cpu():
    """One ``train_fused`` iteration on Ant3D-v0 at a tiny width: a
    ``collect_and_store`` of 3 envs x 6 steps with the sweep acting and
    exploration noise, then 2 updates on ring samples."""
    run = train_fused.build_run(train_fused.parse_args([
        "--env", "Ant3D-v0", "--device", "cpu", "--seed", "3", "--num-envs", "3",
        "--steps-per-iter", "6", "--batch-size", "8", "--latent-dim", "8", "--hidden-dim", "32",
        "--diffusion-steps", "4"]))
    collected = []
    collect = run.collector.collect
    run.collector.collect = lambda *a: collected.append(collect(*a)) or collected[-1]
    run.env_states, _, mean = train_fused.collect_and_store(
        run.agent, run.state, run.collector, run.replay, run.env_states, None, run.generator,
        0.1)
    transitions = collected[0][0]
    assert transitions.observations.shape == transitions.next_observations.shape == (6, 3, 27)
    assert transitions.actions.shape == (6, 3, 8) and transitions.rewards.shape == (6, 3)
    assert all(bool(torch.isfinite(x.float()).all()) for x in transitions)
    assert bool(torch.isfinite(run.env_states.physics).all()) and bool(torch.isfinite(mean))
    ring = run.replay
    assert (ring.host_size, ring.host_pos, int(ring.size), int(ring.pos)) == (18, 18, 18, 18)
    state, metrics = train_fused.train_updates(run.agent, run.state, run.replay, 2, False)
    assert state.step == 2 and all(bool(torch.isfinite(v)) for v in metrics.values())


@pytest.mark.parametrize("preset", ["ant3d_fused", "humanoid3d_fused"])
def test_build_run_config_on_the_3d_presets(preset):
    """``build_run_config`` on the 3D presets against the JAX example's; the
    env is the 3D engine; ``tpu.compute_dtype: bfloat16`` sets the sweep's
    weight type only, the modules train in float32."""
    args = dict(vars(train_fused.parse_args([])), device="cpu",
                config=str(ROOT / "examples" / "configs" / f"{preset}.yaml"))
    env, name, config, training = train_fused.build_run_config(argparse.Namespace(**args))
    jenv, jname, jconfig, jtraining = jax_train_fused.build_run_config(
        argparse.Namespace(**args))
    assert isinstance(env, trigid.Rigid3DEnv) and env.device.type == "cpu"
    assert name == jname
    assert (env.observation_dim, env.action_dim) == (jenv.observation_dim, jenv.action_dim)
    assert config_to_dict(config) == config_to_dict(jconfig)
    assert config_to_dict(training) == config_to_dict(jtraining)
    agent = DiffusionStateAgent(env.observation_dim, env.action_dim, config, training,
                                device="cpu")
    bf16 = config.tpu.compute_dtype == "bfloat16"
    assert bf16 == (preset == "humanoid3d_fused")
    assert agent.core.sweep_dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert {p.dtype for p in agent.core.parameters()} == {torch.float32}
