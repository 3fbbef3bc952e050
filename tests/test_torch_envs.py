"""Port parity: the analytic device envs and the fused loops against
``active_inference_diffusion_tpu/envs/jax_envs.py``.

Every draw is the JAX program's own, rebuilt from its keys: a reset's
unit-uniform numbers (``uniform`` on the reset's state key, or on each of
its split keys), each env's key chain through ``step_autoreset`` (the
fresh episode from the first half of the carried key, the second half
carried on), and a collect's keys (the first reset from the collect key's
first half, each step's policy key the first half of the scan key's
split). The policies are seeded random functions of the observation,
written once per package. Each package runs its functions once per test:
the JAX side as one jitted program per env.

Tolerances: float32 computations of the same formulas in another order,
``ENV_TOL`` (rtol 1e-5 / atol 1e-6) for one step; over a collect the
differences of one step feed the next through the policy and the
dynamics, ``LOOP_TOL`` (rtol 1e-4 / atol 1e-5); dones, step counts and
terminations exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.envs import jax_envs as jenvs
from active_inference_diffusion_torch.envs import device_envs as tenvs
from active_inference_diffusion_torch.envs.device_envs import ResetDraws

CPU = torch.device("cpu")
ENV_TOL = dict(rtol=1e-5, atol=1e-6)
LOOP_TOL = dict(rtol=1e-4, atol=1e-5)
CLASSIC = ["Pendulum-v1", "PointMass2D-v0", "Reacher2Link-v0"]
N = 6


def reset_uniforms(name, key):
    """The unit-uniform numbers a JAX reset draws from ``key``, in the
    port's layout."""
    if name == "Pendulum-v1":
        state_key, _ = jax.random.split(key)
        return jax.random.uniform(state_key, (2,))
    k1, k2, _ = jax.random.split(key, 3)
    return jnp.concatenate([jax.random.uniform(k1, (2,)), jax.random.uniform(k2, (2,))])


def port_env(name, **attrs):
    env = tenvs.make_device_env(name, device=CPU)
    for k, v in attrs.items():
        setattr(env, k, v)
    return env


def jax_env(name, **attrs):
    env = jenvs.make_jax_env(name)
    for k, v in attrs.items():
        setattr(env, k, v)
    return env


def t(x):
    return torch.from_numpy(np.array(x))


def draws_of(name, keys):
    return ResetDraws(t(jax.vmap(lambda k: reset_uniforms(name, k))(keys)))


def check_state(got, want, err="", tol=ENV_TOL):
    for field in ("physics", "obs", "reward"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   err_msg=f"{err} {field}", **tol)
    for field in ("done", "step_count", "terminated"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=f"{err} {field}")


@pytest.mark.parametrize("name", CLASSIC)
def test_classic_env_matches_jax(name):
    """Reset from the same draws; a step from states moved off the reset
    (Pendulum angles past +-pi, where a truncated modulo would differ from
    the floor modulo; actions beyond the bounds); ``step_autoreset`` with
    half the envs at their last step: the fresh episodes where done, the
    finishing step's reward and done, and the true next observation."""
    jenv, env = jax_env(name), port_env(name)
    keys = jax.random.split(jax.random.PRNGKey(3), N)
    rng = np.random.default_rng(4)
    actions = (2.5 * rng.standard_normal((N, env.action_dim))).astype(np.float32)
    limit = env.max_episode_steps

    @jax.jit
    def program(keys, actions):
        states = jax.vmap(jenv.reset)(keys)
        phys = states.physics
        if name == "Pendulum-v1":
            phys = phys.at[:, 0].set(jnp.array([4.0, -4.5, 7.2, -9.9, 3.2, -3.2]))
        states = states.replace(physics=phys,
                                step_count=jnp.array([0, limit - 1] * (N // 2), jnp.int32))
        stepped = jax.vmap(jenv.step)(states, actions)
        auto, true_next = jax.vmap(jenv.step_autoreset)(states, actions)
        fresh_keys = jax.vmap(lambda k: jax.random.split(k)[0])(states.key)
        return jax.vmap(jenv.reset)(keys), states, stepped, auto, true_next, fresh_keys

    reset, states, stepped, auto, true_next, fresh_keys = program(keys, jnp.asarray(actions))
    got_reset = env.reset(draws_of(name, keys))
    check_state(got_reset, reset, "reset")
    start = got_reset.replace(physics=t(states.physics), obs=t(states.obs),
                              step_count=t(states.step_count))
    check_state(env.step(start, t(actions)), stepped, "step")
    got_auto, got_next = env.step_autoreset(start, t(actions), draws_of(name, fresh_keys))
    check_state(got_auto, auto, "step_autoreset")
    np.testing.assert_allclose(got_next.numpy(), np.asarray(true_next), **ENV_TOL)
    assert got_auto.done.any() and not got_auto.done.all()
    np.testing.assert_array_equal(got_auto.step_count.numpy()[got_auto.done.numpy()], 0)


def test_scale_action_and_noise_with_asymmetric_bounds():
    """``scale_action`` and ``add_action_noise`` with per-dimension,
    asymmetric bounds, on the JAX noise draw."""
    low, high = np.array([-1.0, 0.0], np.float32), np.array([3.0, 0.5], np.float32)
    jenv = jax_env("PointMass2D-v0", action_low=jnp.asarray(low), action_high=jnp.asarray(high))
    env = port_env("PointMass2D-v0", action_low=t(low), action_high=t(high))
    action = np.random.default_rng(5).uniform(-1.2, 1.2, (N, 2)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want_scaled = jenv.scale_action(jnp.asarray(action))
    want_noisy = jenvs.add_action_noise(jenv, jnp.asarray(action), key, 0.7)
    noise = t(jax.random.normal(key, (N, 2)))
    np.testing.assert_allclose(env.scale_action(t(action)).numpy(), want_scaled, **ENV_TOL)
    got = tenvs.add_action_noise(env, t(action), noise, torch.tensor(0.7))
    np.testing.assert_allclose(got.numpy(), want_noisy, **ENV_TOL)
    assert (got.numpy() == low).any() and (got.numpy() == high).any()


# -- the fused loops, with seeded random policies ---------------------------

W = np.random.default_rng(8).standard_normal((8, 2)).astype(np.float32)


def jax_policy(obs, key):
    a = jnp.tanh(obs @ W[: obs.shape[1], : 1 if obs.shape[1] == 3 else 2])
    return a + 0.5 * jax.random.normal(key, a.shape)


class PortPolicy:
    """The same policy with its noise as an explicit draw."""

    stateful = False

    def __init__(self, action_dim):
        self.action_dim = action_dim

    def draw(self, n, generator):
        return torch.randn((n, self.action_dim), generator=generator)

    def __call__(self, obs, noise):
        w = torch.from_numpy(W[: obs.shape[1], : self.action_dim])
        return torch.tanh(obs @ w) + 0.5 * noise


def jax_warm_policy(obs, key, carry, reset_mask):
    carry = jnp.where(reset_mask, 0.0, 0.9 * carry + obs[:, 0])
    return jax_policy(obs, key) + carry[:, None], carry


def port_warm_policy(obs, noise, carry, reset_mask):
    carry = torch.where(reset_mask, 0.0, 0.9 * carry + obs[:, 0])
    return PortPolicy(noise.shape[1])(obs, noise) + carry[:, None], carry


def collect_draws(name, key, num_envs, num_steps, action_dim):
    """The port's ``CollectDraws`` from a JAX collect's key: the first
    reset's, then per step the policy's noise and each env's autoreset
    draws along its key chain."""
    reset_key, scan_key = jax.random.split(key)
    env_keys = jax.random.split(reset_key, num_envs)
    first = draws_of(name, env_keys)
    parts = 2 if name == "Pendulum-v1" else 3  # a reset's key splits; the last is carried
    chain = jax.vmap(lambda k: jax.random.split(k, parts)[-1])(env_keys)
    steps = []
    for step_key in jax.random.split(scan_key, num_steps):
        act_key, _ = jax.random.split(step_key)
        noise = t(jax.random.normal(act_key, (num_envs, action_dim)))
        fresh = jax.vmap(lambda k: jax.random.split(k)[0])(chain)
        steps.append(tenvs.StepDraws(noise, draws_of(name, fresh)))
        chain = jax.vmap(lambda k: jax.random.split(k)[1])(chain)
    return tenvs.CollectDraws(first, steps)


def check_transitions(got, want):
    for field in got._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=field)
        else:
            np.testing.assert_allclose(g, w, err_msg=field, **LOOP_TOL)


@pytest.mark.parametrize("name", ["Pendulum-v1", "Reacher2Link-v0"])
def test_fused_collect_matches_jax(name):
    """``fused_collect`` (exploration noise on top, the collect's own
    flattening) and ``fused_collect_stateful`` (a carry reset where the
    previous step ended an episode) over time limits cut to 5 steps, so
    episodes end and restart inside the collect, on JAX's draws; the
    final env states too."""
    limit, steps, eps = 5, 12, 0.3
    jenv, env = jax_env(name, max_episode_steps=limit), port_env(name, max_episode_steps=limit)
    act = env.action_dim
    key, skey = jax.random.PRNGKey(11), jax.random.PRNGKey(12)

    @jax.jit
    def program(key, skey):
        noisy = jenvs.with_exploration_noise(jax_policy, jenv, eps)
        tr, states = jenvs.fused_collect(jenv, noisy, key, N, steps)
        trs, states_s, carry = jenvs.fused_collect_stateful(
            jenv, jax_warm_policy, skey, N, steps, jnp.zeros(N))
        return jenvs.flatten_transitions(tr), states, trs, states_s, carry

    flat, states, trs, states_s, carry = program(key, skey)

    # the noisy policy's key is split (policy, noise): rebuild both draws
    draws = collect_draws(name, key, N, steps, act)
    _, scan_key = jax.random.split(key)
    steps_draws = []
    for s, step_key in zip(draws.steps, jax.random.split(scan_key, steps)):
        pk, nk = jax.random.split(jax.random.split(step_key)[0])
        steps_draws.append(s._replace(policy=tenvs.NoisyDraws(
            t(jax.random.normal(pk, (N, act))), t(jax.random.normal(nk, (N, act))))))
    noisy = tenvs.with_exploration_noise(PortPolicy(act), env, eps)
    tr, got_states = tenvs.fused_collect(env, noisy, draws._replace(steps=steps_draws))
    check_transitions(tenvs.flatten_transitions(tr), flat)
    check_state(got_states, states, "final", LOOP_TOL)
    assert tr.dones.any()

    sdraws = collect_draws(name, skey, N, steps, act)
    trs_got, states_got, carry_got = tenvs.fused_collect_stateful(
        env, port_warm_policy, sdraws, torch.zeros(N))
    check_transitions(trs_got, trs)
    check_state(states_got, states_s, "stateful final", LOOP_TOL)
    np.testing.assert_allclose(carry_got.numpy(), np.asarray(carry), **LOOP_TOL)


def test_fused_eval_matches_jax():
    """``fused_eval``: one episode per env, no autoreset, rewards after done
    masked out (a time limit of 5 inside 8 steps), on JAX's draws."""
    name, limit, steps = "Pendulum-v1", 5, 8
    jenv, env = jax_env(name, max_episode_steps=limit), port_env(name, max_episode_steps=limit)
    key = jax.random.PRNGKey(13)
    want = jax.jit(lambda k: jenvs.fused_eval(jenv, jax_policy, k, N, steps))(key)
    reset_key, scan_key = jax.random.split(key)
    draws = tenvs.EvalDraws(draws_of(name, jax.random.split(reset_key, N)),
                            [t(jax.random.normal(k, (N, 1)))
                             for k in jax.random.split(scan_key, steps)])
    got = tenvs.fused_eval(env, PortPolicy(1), draws)
    np.testing.assert_allclose(float(got), float(want), **LOOP_TOL)
    # masking: the same episodes cut at the time limit give the same return
    short = tenvs.fused_eval(env, PortPolicy(1), draws._replace(steps=draws.steps[:limit]))
    assert float(short) == float(got)


def test_make_device_env_names():
    assert isinstance(port_env("Pendulum-v1"), tenvs.Pendulum)
    assert port_env("HopperPlanar-v0").observation_dim == 11
    for name, dims in (("Ant3D-v0", (27, 8)), ("Humanoid3D-v0", (376, 17)),
                       ("HumanoidStandup3D-v0", (376, 17))):
        env = port_env(name)
        assert (env.observation_dim, env.action_dim) == dims, name
    for name, item in (("Ant3DPixels-v0", "A11"), ("PendulumPixels-v0", "A11"),
                       ("HalfCheetah-v4", "A13")):
        with pytest.raises(NotImplementedError, match=item):
            tenvs.make_device_env(name, device=CPU)
    with pytest.raises(ValueError):
        tenvs.make_device_env("CartPole-v1", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tenvs.make_device_env("Pendulum-v1")


# -- the -v4 task semantics (envs/mujoco_tasks.py) ---------------------------

_NQ = {"HalfCheetah-v4": (9, 9, 8), "Hopper-v4": (6, 6, 5), "Walker2d-v4": (9, 9, 8),
       "Ant-v4": (15, 14, 14), "Humanoid-v4": (24, 23, 14), "HumanoidStandup-v4": (24, 23, 14)}


@pytest.mark.parametrize("name", sorted(_NQ))
def test_task_semantics_match_jax(name):
    """Every ``TASK_SPECS`` entry: the observation (full-body fields where
    the task reads them), the healthy predicate and termination (states
    spread across the healthy ranges), the reward (forward progress from
    the task's position, healthy bonus, control and contact costs, the
    standup form), and the reset noise on JAX's draws."""
    from active_inference_diffusion_tpu.envs import mujoco_tasks as jtasks
    from active_inference_diffusion_torch.envs import mujoco_tasks as ttasks

    spec, tspec = jtasks.TASK_SPECS[name], ttasks.TASK_SPECS[name]
    assert dataclasses.asdict(spec) == dataclasses.asdict(tspec)
    nq, nv, nb = _NQ[name]
    rng = np.random.default_rng(len(name))

    def fields():
        qpos = rng.uniform(-1.5, 1.5, (N, nq)).astype(np.float32)
        qpos[:, 1:3] = rng.uniform(0.0, 2.2, (N, 2))  # heights across the healthy ranges
        qpos[0, 3] = np.inf if spec.check_finite_healthy else qpos[0, 3]
        qvel = rng.uniform(-15.0, 15.0, (N, nv)).astype(np.float32)
        # env 1 healthy: small angles and velocities, the height inside its range
        qpos[1], qvel[1] = 0.01, 0.1
        if spec.healthy_z_range is not None:
            lo, hi = spec.healthy_z_range
            qpos[1, 2 if spec.exclude_positions == 2 else 1] = lo + min(0.5, (hi - lo) / 2)
        extra = {}
        if spec.full_body_obs or spec.use_contact_forces or spec.forward_from != "x":
            extra = dict(cinert=rng.standard_normal((N, nb, 10)), cvel=rng.standard_normal((N, nb, 6)),
                         qfrc_actuator=rng.standard_normal((N, nv)),
                         cfrc_ext=3.0 * rng.standard_normal((N, nb, 6)),
                         xipos=rng.standard_normal((N, nb, 3)),
                         torso_xpos=rng.standard_normal((N, 3)))
            extra = {k: v.astype(np.float32) for k, v in extra.items()}
        return dict(qpos=qpos, qvel=qvel, **extra)

    before, after = fields(), fields()
    action = rng.uniform(-1, 1, (N, 8)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, nb).astype(np.float32)
    jf = lambda f: jtasks.MjPhysicsFields(**{k: jnp.asarray(v) for k, v in f.items()})  # noqa: E731
    tf = lambda f: ttasks.MjPhysicsFields(**{k: t(v) for k, v in f.items()})  # noqa: E731
    if spec.full_body_obs or spec.forward_from == "x" or spec.use_contact_forces:
        want_obs = jax.vmap(lambda f: jtasks.task_observation(spec, f))(jf(after))
        np.testing.assert_allclose(ttasks.task_observation(tspec, tf(after)).numpy(), want_obs,
                                   **ENV_TOL)
    want_term = jax.vmap(lambda q, v: jtasks.task_terminated(spec, q, v))(
        jnp.asarray(after["qpos"]), jnp.asarray(after["qvel"]))
    got_term = ttasks.task_terminated(tspec, t(after["qpos"]), t(after["qvel"]))
    np.testing.assert_array_equal(got_term.numpy(), np.broadcast_to(want_term, (N,)))
    if spec.terminate_when_unhealthy:
        assert got_term.any() and not got_term.all()
    want_r = jax.vmap(lambda a, b, u: jtasks.task_reward(spec, a, b, u, 0.01, jnp.asarray(mass),
                                                         0.003))(jf(before), jf(after),
                                                                 jnp.asarray(action))
    got_r = ttasks.task_reward(tspec, tf(before), tf(after), t(action), 0.01, t(mass), 0.003)
    np.testing.assert_allclose(got_r.numpy(), want_r, rtol=1e-5, atol=1e-4)
    key = jax.random.PRNGKey(9)
    init_q, init_v = jnp.asarray(before["qpos"][0]), jnp.zeros(nv, jnp.float32)
    want_q, want_v = jtasks.reset_qpos_qvel(spec, key, init_q, init_v)
    kq, kv = jax.random.split(key)
    draw_v = (jax.random.normal(kv, (nv,)) if spec.qvel_noise == "normal"
              else jax.random.uniform(kv, (nv,)))
    got_q, got_v = ttasks.reset_qpos_qvel(tspec, t(init_q)[None], t(init_v)[None],
                                          t(jax.random.uniform(kq, (nq,)))[None], t(draw_v)[None])
    np.testing.assert_allclose(got_q[0].numpy(), want_q, **ENV_TOL)
    np.testing.assert_allclose(got_v[0].numpy(), want_v, **ENV_TOL)
