"""Port parity: the rollout policies, ``train_fused`` and its loop body.

- ``make_rollout_policy`` (sweep acting with deterministic beliefs and a
  sampled action, eval, posterior acting) and ``make_warm_rollout_policy``
  against the JAX package's on bridged weights, on the JAX policies' own
  draws rebuilt from their keys: the key splits in 3 (encoder, belief,
  action; 4 with the warm policy's reset key), the sweep's start (or warm
  start's forward noise) from the belief key's first half, the posterior's
  eps from the belief key itself, the action sample's eps from the action
  key. The env's action bounds are asymmetric, so ``scale_action`` shows.
- The slice as a whole: one ``train_fused`` iteration on Pendulum-v1 at the
  tiny widths (the flagship's training flags, deterministic beliefs):
  ``collect_and_store`` (4 envs x 3 steps with exploration noise into a
  ring) and 2 updates by ``train_step`` on ring samples, chained against the
  JAX example's loop body (``fused_collect`` with ``with_exploration_noise``,
  ``replay_add_batch`` with the terminations, ``replay_sample`` and the JAX
  agent's ``train_step``) on the JAX draws: the transitions, the ring, then
  each update by ``check_update``'s rules.
- ``build_run_config`` against the JAX example's on the cases of
  tests/test_train_fused_config.py; the collect and eval loops' eager
  steps against ``fused_collect_stateful`` and ``fused_eval``; ``main`` on
  the CPU, and the flags it does not port raising.

Tolerances: actions and latents ``ACT_TOL`` (rtol 1e-4 / atol 1e-5, as
tests/test_torch_act.py); the ring and transitions after a collect
``LOOP_TOL`` (rtol 1e-4 / atol 1e-5); the updates ``check_update``'s.
"""

import argparse
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.configs.config import config_to_dict
from active_inference_diffusion_tpu.data import replay as jreplay
from active_inference_diffusion_tpu.envs import jax_envs as jenvs
from active_inference_diffusion_torch import train_fused
from active_inference_diffusion_torch.data.replay import replay_init
from active_inference_diffusion_torch.envs import collect_graph
from active_inference_diffusion_torch.envs import device_envs as tenvs
from torch_parity import (
    ACT_DIM,
    CPU,
    OBS_DIM,
    B,
    D,
    check_update,
    draws_from_jax,
    jax_agent,
    jax_core_and_params,
    jax_train_state,
    jax_train_step,
    normal,
    numpy_tree,
    record,
    start,
    t,
    tiny_config,
    torch_agent,
)

ROOT = Path(__file__).resolve().parents[1]
ACT_TOL = dict(rtol=1e-4, atol=1e-5)
LOOP_TOL = dict(rtol=1e-4, atol=1e-5)
LOW, HIGH = np.array([-1.0, 0.0], np.float32), np.array([2.0, 0.5], np.float32)


def jnormal(key, *shape):
    return t(np.asarray(jax.random.normal(key, shape, jnp.float32)))


def rollout_draws(key, n, warm=False, posterior=False):
    """The port's ``RolloutDraws`` of a JAX rollout policy's key."""
    keys = jax.random.split(key, 4 if warm else 3)
    belief_key, act_key = keys[1], keys[2]
    start_key = belief_key if posterior else jax.random.split(belief_key)[0]
    fresh = jnormal(keys[3], n, D) if warm else None
    return tenvs.RolloutDraws(jnormal(start_key, n, D), torch.tensor(0, dtype=torch.int64),
                              jnormal(act_key, n, ACT_DIM), fresh)


def test_rollout_policies_match_jax():
    cfg = tiny_config(deterministic_beliefs=True, kl_weight=0.5)
    jagent, jstate = jax_agent(cfg), jax_train_state(cfg)
    params = jstate.params
    jenv = jenvs.JaxEnv()
    jenv.action_low, jenv.action_high = jnp.asarray(LOW), jnp.asarray(HIGH)
    env = tenvs.DeviceEnv(device=CPU)
    env.action_low, env.action_high, env.action_dim = t(LOW), t(HIGH), ACT_DIM
    agent = torch_agent(cfg, params)
    core = agent.core
    obs = 2.0 * normal(40, B, OBS_DIM)
    prev = normal(41, B, D)
    reset = np.arange(B) % 3 == 0
    keys = jax.random.split(jax.random.PRNGKey(42), 4)

    @jax.jit
    def program(params, obs, prev, reset, keys):
        jc = jagent.core
        return dict(
            sweep=jenvs.make_rollout_policy(jc, jenv, deterministic_beliefs=True)(
                params, obs, keys[0]),
            eval=jenvs.make_rollout_policy(jc, jenv, deterministic=True)(params, obs, keys[1]),
            posterior=jenvs.make_rollout_policy(jc, jenv, act_from_posterior=True)(
                params, obs, keys[2]),
            warm=jenvs.make_warm_rollout_policy(jc, jenv, num_steps=3,
                                                deterministic_beliefs=True)(
                params, obs, keys[3], prev, reset),
        )

    want = jax.tree_util.tree_map(np.asarray, program(params, obs, prev, reset, keys))
    policies = {
        "sweep": tenvs.make_rollout_policy(core, env, deterministic_beliefs=True),
        "eval": tenvs.make_rollout_policy(core, env, deterministic=True),
        "posterior": tenvs.make_rollout_policy(core, env, act_from_posterior=True),
    }
    for i, (name, policy) in enumerate(policies.items()):
        draws = rollout_draws(keys[i], B, posterior=name == "posterior")
        got = policy(t(obs), draws)
        np.testing.assert_allclose(got.numpy(), want[name], err_msg=name, **ACT_TOL)
        assert (got.numpy() >= LOW).all() and (got.numpy() <= HIGH).all()
    warm = tenvs.make_warm_rollout_policy(core, env, num_steps=3, deterministic_beliefs=True)
    actions, latent = warm(t(obs), rollout_draws(keys[3], B, warm=True), t(prev),
                           torch.from_numpy(reset))
    np.testing.assert_allclose(actions.numpy(), want["warm"][0], err_msg="warm", **ACT_TOL)
    np.testing.assert_allclose(latent.numpy(), want["warm"][1], err_msg="warm latent", **ACT_TOL)


PENDULUM = dict(observation_dim=3, action_dim=1, deterministic_beliefs=True, kl_weight=0.5)
NUM_ENVS, STEPS, RING, EPS = 4, 3, 16, 0.1


def test_train_fused_iteration_matches_jax_loop_body(monkeypatch):
    cfg = tiny_config(**PENDULUM)
    jagent, jstates = jax_agent(cfg), [jax_train_state(cfg)]
    agent, state, grads = start(cfg, numpy_tree(jstates[0]))
    jenv = jenvs.make_jax_env("Pendulum-v1")
    env = tenvs.make_device_env("Pendulum-v1", device=CPU)
    key = jax.random.PRNGKey(50)

    # the JAX example's collect_and_store
    rollout = jenvs.make_rollout_policy(jagent.core, jenv, deterministic_beliefs=True)

    @jax.jit
    def jax_collect(params, replay, key):
        pol = jenvs.with_exploration_noise(lambda o, k: rollout(params, o, k), jenv,
                                           jnp.float32(EPS))
        transitions, _ = jenvs.fused_collect(jenv, pol, key, NUM_ENVS, STEPS)
        flat = jenvs.flatten_transitions(transitions)
        replay = jreplay.replay_add_batch(replay, flat.observations, flat.actions,
                                          flat.rewards, flat.next_observations,
                                          flat.terminateds)
        return replay, flat, jnp.mean(flat.rewards)

    jring, jflat, jmean = jax_collect(jstates[0].params,
                                      jreplay.replay_init(RING, (3,), 1), key)

    # the same collect in the port, on the JAX draws
    reset_key, scan_key = jax.random.split(key)
    env_keys = jax.random.split(reset_key, NUM_ENVS)

    def reset_draws(keys):
        u = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (2,)))(keys)
        return tenvs.ResetDraws(t(np.asarray(u)))

    chain = jax.vmap(lambda k: jax.random.split(k)[1])(env_keys)
    pending = []
    for step_key in jax.random.split(scan_key, STEPS):
        pk, nk = jax.random.split(jax.random.split(step_key)[0])
        keys = jax.random.split(pk, 3)
        policy = tenvs.RolloutDraws(jnormal(jax.random.split(keys[1])[0], NUM_ENVS, D),
                                    torch.tensor(0, dtype=torch.int64),
                                    jnormal(keys[2], NUM_ENVS, 1))
        fresh = jax.vmap(lambda k: jax.random.split(k)[0])(chain)
        pending.append(tenvs.StepDraws(tenvs.NoisyDraws(policy, jnormal(nk, NUM_ENVS, 1)),
                                       reset_draws(fresh)))
        chain = jax.vmap(lambda k: jax.random.split(k)[1])(chain)
    monkeypatch.setattr(tenvs, "draw_step", lambda *args: pending.pop(0))
    collector = collect_graph.CollectGraph(
        env, tenvs.ExplorationNoise(tenvs.make_rollout_policy(
            agent.core, env, deterministic_beliefs=True), env, torch.zeros(())),
        NUM_ENVS, STEPS)
    ring = replay_init(RING, (3,), 1, device=CPU)
    env_states = env.reset(reset_draws(env_keys))
    _, _, mean = train_fused.collect_and_store(agent, state, collector, ring, env_states, None,
                                               None, train_fused.exploration_eps(
                                                   agent.training_config, 0))
    assert not pending
    assert train_fused.exploration_eps(agent.training_config, 0) == EPS
    np.testing.assert_allclose(float(mean), float(jmean), **LOOP_TOL)
    for field in ("observations", "actions", "rewards", "next_observations", "dones"):
        np.testing.assert_allclose(getattr(ring, field).numpy(), np.asarray(getattr(jring, field)),
                                   err_msg=field, **LOOP_TOL)
    assert ring.host_size == int(jring.size) == NUM_ENVS * STEPS and int(ring.pos) == int(jring.pos)

    # two updates on ring samples, the JAX loop body's replay_sample then train_step
    updates = []
    for i in range(2):
        skey = jax.random.PRNGKey(60 + i)
        indices = jax.random.randint(skey, (B,), 0, jnp.maximum(jring.size, 1))
        jbatch = jreplay.replay_sample(jring, skey, B)
        jbatch["dones"] = jbatch["dones"].astype(jnp.float32)
        draws = draws_from_jax(jagent, jstates[-1], B)
        jstate, jmetrics = jax_train_step(jagent, jstates[-1], jbatch)
        jstates.append(jstate)
        updates.append((torch.from_numpy(np.asarray(indices, np.int64)), draws, jstate, jmetrics))
    queue = list(updates)
    monkeypatch.setattr(train_fused, "draw_indices", lambda *args: queue[0][0])
    out = []

    def draw_train(state, batch_size):
        return queue[0][1]

    agent.draw_train = draw_train
    for _, draws, jstate, jmetrics in updates:
        state, metrics = train_fused.train_updates(agent, state, ring, 1, train_epoch=False)
        out.append(record(agent, state, metrics, jstate, jmetrics, draws, grads))
        queue.pop(0)
    for step in range(2):
        check_update(agent, jstates, out, step)


def test_collect_and_eval_graphs_run_the_eager_steps_on_the_cpu():
    """On the CPU ``CollectGraph`` and ``EvalGraph`` run the eager steps, on
    the draws ``draw_collect`` and ``draw_eval`` make from the same
    generator state, in the same order."""
    cfg = tiny_config(observation_dim=3, action_dim=1)
    _, params = jax_core_and_params(cfg)
    agent = torch_agent(cfg, params)
    env = tenvs.make_device_env("Pendulum-v1", device=CPU)
    warm = tenvs.ExplorationNoise(tenvs.make_warm_rollout_policy(agent.core, env, num_steps=2),
                                  env, torch.tensor(0.2))
    g = torch.Generator().manual_seed(3)
    states = env.reset(env.draw_reset(5, g))
    latents = tenvs.init_warm_state(5, D, g)
    snapshot = g.get_state()
    tr, got_states, got_latents = collect_graph.CollectGraph(env, warm, 5, 4).collect(
        states, latents, g)
    g.set_state(snapshot)
    want, want_states, want_latents = tenvs.fused_collect_stateful(
        env, warm, tenvs.draw_collect(env, warm, 5, 4, g, reset=False), latents, states)
    for a, b in zip(tr, want):
        assert torch.equal(a, b)
    assert torch.equal(got_states.physics, want_states.physics)
    assert torch.equal(got_latents, want_latents)
    policy = tenvs.make_rollout_policy(agent.core, env, deterministic=True)
    snapshot = g.get_state()
    got = collect_graph.EvalGraph(env, policy, 5, 7).evaluate(g)
    g.set_state(snapshot)
    assert float(got) == float(tenvs.fused_eval(env, policy, tenvs.draw_eval(env, policy, 5, 7, g)))


# -- build_run_config against the JAX example's -----------------------------

_spec = importlib.util.spec_from_file_location("jax_train_fused", ROOT / "examples" /
                                               "train_fused.py")
jax_train_fused = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_train_fused)


def _args(**over):
    """The parser's defaults (tests/test_train_fused_config.py's), overridden."""
    defaults = vars(train_fused.parse_args([]))
    defaults.update(device="cpu", latent_dim=16, hidden_dim=64)
    defaults.update(over)
    return argparse.Namespace(**defaults)


def _yaml(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("active_inference:\n  env_name: PointMass2D-v0\n  latent_dim: 8\n"
                 "  hidden_dim: 32\ntraining:\n  buffer_size: 12345\n")
    return str(p)


@pytest.mark.parametrize("case", ["yaml-env", "env-flag-wins", "buffer-flag-wins",
                                  "flag-defaults", "anchor-warmup", "planar-preset"])
def test_build_run_config_matches_jax_example(case, tmp_path):
    over = {
        "yaml-env": dict(config=_yaml(tmp_path)),
        "env-flag-wins": dict(config=_yaml(tmp_path), env="Pendulum-v1"),
        "buffer-flag-wins": dict(config=_yaml(tmp_path), buffer_size=777),
        "flag-defaults": dict(latent_dim=8, hidden_dim=32),
        "anchor-warmup": dict(policy_anchor_weight=0.5, policy_anchor_warmup=1234),
        "planar-preset": dict(config=str(ROOT / "examples/configs/hopper_planar_fused.yaml")),
    }[case]
    env, name, config, training = train_fused.build_run_config(_args(**over))
    jenv, jname, jconfig, jtraining = jax_train_fused.build_run_config(_args(**over))
    assert name == jname
    assert (env.observation_dim, env.action_dim) == (jenv.observation_dim, jenv.action_dim)
    assert config_to_dict(config) == config_to_dict(jconfig)
    assert config_to_dict(training) == config_to_dict(jtraining)


def test_train_fused_main_on_the_cpu(tmp_path):
    """``main`` on the CPU: Pendulum with the sweep acting and a warm-start
    collect, two iterations with updates by ``train_epoch`` and an eval; its
    JSONL log; ``--video-every``, not ported, raises naming its ROADMAP
    item; without a card and without ``--device cpu`` it raises."""
    base = ["--device", "cpu", "--num-envs", "4", "--steps-per-iter", "4",
            "--updates-per-iter", "2", "--iterations", "2", "--batch-size", "8",
            "--latent-dim", "8", "--hidden-dim", "32", "--diffusion-steps", "4",
            "--log-dir", str(tmp_path)]
    assert train_fused.main(base + ["--train-epoch", "--warm-start-steps", "2",
                                    "--eval-every", "1", "--eval-envs", "2"]) == 0
    lines = (tmp_path / "fused_Pendulum-v1.jsonl").read_text().splitlines()
    assert len(lines) == 2 and "fused/eval_return" in lines[-1] and "score_matching_loss" in lines[-1]
    with pytest.raises(NotImplementedError, match="A12"):
        train_fused.main(base + ["--video-every", "1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_fused.main(base[2:])
