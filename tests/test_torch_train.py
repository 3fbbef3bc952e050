"""Port parity: the flagship-flag train update as a whole.

The JAX agent's train step (its ``_train_step_impl``, compiled once by
``jax_train_step``) and the port's ``train_step_from_draws`` start from the
same state (the JAX state built by
``jax_train_state``, carried over by ``train_state_from_jax``) and take the
same batch, with every draw of the JAX step rebuilt here from its keys, in
the order ``_train_step_impl`` splits them (``draws_from_jax``). Beliefs
are deterministic (``deterministic_beliefs``), so the sweep's own noise
plays no part. Two chained steps: step 0 runs the MINE update, step 1 skips
it.

Tolerances:
- every metric the JAX step returns, and the updated time importance,
  reward normaliser, score EMA and MINE running mean: ``MODEL_TOL``;
- the gradients of each partition, as the optimizers' first moments
  (Adam's mu is 0.1 g after one step, 0.9 mu_0 + 0.1 g after two): rtol
  2e-4, atol 2e-5 times the partition's largest moment (gradients are
  clipped to a global norm of 0.5, so an absolute 2e-5 would not be
  tight); where a clamp or a dead unit makes a step-0 JAX gradient exactly
  0, the port's is exactly 0 too;
- updated parameters: ``MODEL_TOL``, except that Adam's first steps move an
  element by about lr x sign(g): where the two packages' gradients have
  opposite signs (or one is 0 and the other not), an element may differ by
  up to 2 lr a step. The gradient check above bounds the two gradients'
  difference, so the rule covers only gradients within their tolerance of
  0. g of step 1 is taken as (mu_1 - 0.9 mu_0) / 0.1. The test prints how
  many elements the rule covers (``-s``) and asserts fewer than 1 in 100
  of each partition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from active_inference_diffusion_tpu.configs.config import TrainingConfig
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.bridge import group_arrays, train_state_from_jax
from active_inference_diffusion_torch.core.active_inference import GROUP_MODULES
from torch_parity import (
    ACT_DIM,
    CPU,
    MODEL_TOL,
    OBS_DIM,
    B,
    draws_from_jax,
    jax_agent,
    jax_train_state,
    jax_train_step,
    normal,
    numpy_tree,
    port_config,
    t,
    train_config,
)

GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
# The partitions' learning rates at the config's defaults (lr 5e-5, the
# epistemic one a tenth).
LEARNING_RATES = {"score": 5e-5, "policy": 5e-5, "value": 5e-5, "model": 5e-5,
                  "epistemic": 5e-6}

def make_batch(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "observations": normal(seed, B, OBS_DIM),
        "next_observations": normal(seed + 1, B, OBS_DIM),
        "actions": np.tanh(normal(seed + 2, B, ACT_DIM)),
        "rewards": 2.0 * normal(seed + 3, B),
        "dones": (rng.random(B) < 0.25).astype(np.float32),
    }


def port_grads(out, part, step):
    """A partition's port gradients at ``step``, in its optimizer's order."""
    mu = out[step]["mu"][part]
    if step == 0:
        return [m / 0.1 for m in mu]
    return [(m - 0.9 * m0) / 0.1 for m, m0 in zip(mu, out[step - 1]["mu"][part])]


def jax_grads(out, agent, part, step):
    """A partition's JAX gradients at ``step``, by (group, name), from the
    first moments."""
    mu = jax_by_name(agent, adam_mu(out[step]["jstate"].opt_states[part]))
    if step == 0:
        return {k: v / 0.1 for k, v in mu.items()}
    mu0 = jax_by_name(agent, adam_mu(out[step - 1]["jstate"].opt_states[part]))
    return {k: (v - 0.9 * mu0[k]) / 0.1 for k, v in mu.items()}


def adam_mu(opt_state):
    """The first moment of an ``optax.chain(clip, adamw)`` state."""
    for part in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(part, "mu"):
            return part.mu
    raise KeyError("no Adam state")


def named(agent, partition):
    """(group, torch name) of each parameter of a partition, in its
    optimizer's order."""
    return [(g, n) for g in agent.PARTITIONS[partition]
            for n, _ in getattr(agent.core, GROUP_MODULES[g]).named_parameters()]


def jax_by_name(agent, tree):
    """A tree of JAX parameter groups as {(group, torch name): array}."""
    out = {}
    for group, sub in tree.items():
        if group in GROUP_MODULES:
            module = getattr(agent.core, GROUP_MODULES[group])
            out.update({(group, n): a for n, a in group_arrays(module, sub, group).items()})
    return out


@pytest.fixture(scope="module")
def steps():
    """Two chained updates of both agents from one state and batch each."""
    cfg = train_config()
    jagent = jax_agent(cfg)
    jstates = [jax_train_state(cfg)]
    agent = DiffusionStateAgent(
        OBS_DIM, ACT_DIM, port_config(cfg), port_config(TrainingConfig()), device=CPU
    )
    state = train_state_from_jax(agent, numpy_tree(jstates[0]))
    out = []
    for i in range(2):
        batch = make_batch(10 * i + 3)
        draws = draws_from_jax(jagent, jstates[-1], B)
        jstate, jmetrics = jax_train_step(jagent, jstates[-1],
                                          {k: jnp.asarray(v) for k, v in batch.items()})
        jstates.append(jstate)
        state, metrics = agent.train_step_from_draws(
            state, {k: t(v) for k, v in batch.items()}, draws
        )
        out.append(dict(
            jmetrics=numpy_tree(jmetrics), metrics={k: v.numpy() for k, v in metrics.items()},
            jstate=numpy_tree(jstate), mine=draws.mine is not None,
            params={(g, n): p.detach().numpy().copy() for part in agent.PARTITIONS
                    for (g, n), p in zip(named(agent, part), state.optimizers[part].params)},
            mu={part: [state.optimizers[part].adamw.state[p]["exp_avg"].numpy().copy()
                       for p in state.optimizers[part].params] for part in agent.PARTITIONS},
            ema={n: v.numpy().copy() for n, v in state.ema_score.items()},
            time_importance=state.time_importance.numpy().copy(),
            reward_norm=[float(x) for x in (state.reward_norm.mean, state.reward_norm.var,
                                             state.reward_norm.count)],
            running_mean=float(state.epistemic_running_mean), step=state.step,
        ))
    return agent, jstates, out


@pytest.mark.parametrize("step", [0, 1], ids=["step0-with-mine", "step1-without-mine"])
def test_train_step_matches_jax_agent(steps, step):
    agent, jstates, out = steps
    got = out[step]
    jstate = got["jstate"]
    assert got["mine"] == (step == 0) and got["step"] == step + 1
    assert set(got["metrics"]) == set(got["jmetrics"])
    for name, value in got["jmetrics"].items():
        np.testing.assert_allclose(got["metrics"][name], value, err_msg=name, **MODEL_TOL)
    assert (got["metrics"]["epistemic_mi"] != 0) == (step == 0)

    np.testing.assert_allclose(got["time_importance"], jstate.time_importance, **MODEL_TOL)
    norm = jstate.reward_norm
    np.testing.assert_allclose(got["reward_norm"], [norm.mean, norm.var, norm.count], **MODEL_TOL)
    np.testing.assert_allclose(got["running_mean"], jstate.epistemic_running_mean, **MODEL_TOL)
    ema = group_arrays(agent.core.score_network, jstate.ema_score, "score")
    for name, value in got["ema"].items():
        np.testing.assert_allclose(value, ema[name], err_msg=name, **MODEL_TOL)

    jparams = jax_by_name(agent, jstate.params)
    for part in agent.PARTITIONS:
        names = named(agent, part)
        # gradients, as the first moments: 0.1 g after step 0
        jmu = jax_by_name(agent, adam_mu(jstate.opt_states[part]))
        mu_scale = max(float(np.abs(jmu[k]).max()) for k in names)
        for k, m in zip(names, got["mu"][part]):
            np.testing.assert_allclose(m, jmu[k], rtol=GRAD_RTOL, atol=GRAD_ATOL * mu_scale,
                                       err_msg=f"{part} first moment {k}")
            if step == 0:  # a clamp or a dead unit: exactly zero on both sides
                assert (m[jmu[k] == 0] == 0).all(), (part, k)
        # parameters: MODEL_TOL, or 2 lr a step where the sign of g is open
        lr = LEARNING_RATES[part]
        jgrads = [jax_grads(out, agent, part, s) for s in range(step + 1)]
        pgrads = [port_grads(out, part, s) for s in range(step + 1)]
        small = total = 0
        for i, k in enumerate(names):
            slack = 2 * lr * sum(
                np.sign(gp[i]) != np.sign(gj[k]) for gj, gp in zip(jgrads, pgrads)
            )
            small += int(np.count_nonzero(slack))
            total += slack.size
            err = np.abs(got["params"][k] - jparams[k])
            bound = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * np.abs(jparams[k]) + slack
            assert (err <= bound).all(), (part, k, float((err - bound).max()))
        print(f"{part}: {small} of {total} elements under the sign rule")
        assert small * 100 < total, (part, small, total)
