"""Port parity: the flagship-flag train update as a whole.

The JAX agent's train step (its ``_train_step_impl``, compiled once by
``jax_train_step``) and the port's ``train_step_from_draws`` start from the
same state (the JAX state built by
``jax_train_state``, carried over by ``train_state_from_jax``) and take the
same batch, with every draw of the JAX step rebuilt here from its keys, in
the order ``_train_step_impl`` splits them (``draws_from_jax``). Beliefs
are deterministic (``deterministic_beliefs``), so the sweep's own noise
plays no part. Two chained steps: step 0 runs the MINE update, step 1 skips
it. Then the slice as a whole: three chained ``train_epoch`` calls of one
update each over a device ring, against the JAX ``train_epoch``'s scan body
(a batch from the JAX ring on ``fold_in(k, 0)``, then the same compiled JAX
step), the ring indices and the draws JAX's; the same rules.

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
  0. JAX's g of step k > 0 is taken as (mu_k - 0.9 mu_{k-1}) / 0.1, the port's
  is the clipped gradient its AdamW took. The test prints how
  many elements the rule covers (``-s``) and asserts fewer than 1 in 100
  of each partition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.configs.config import TrainingConfig
from active_inference_diffusion_tpu.data import replay as jreplay
from active_inference_diffusion_torch.agents.base import RewardNormState
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.bridge import group_arrays, train_state_from_jax
from active_inference_diffusion_torch.core.active_inference import GROUP_MODULES
from active_inference_diffusion_torch.core.epistemic import estimate_epistemic_value
from active_inference_diffusion_torch.core.time_sampler import update_time_importance
from active_inference_diffusion_torch.data.replay import DeviceReplayBuffer
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
    torch_core,
    train_config,
)

GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
RING = 16  # the epoch's ring: 20 transitions wrap it
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
    """A partition's port gradients at ``step``, in its optimizer's order:
    the clipped gradients its AdamW took, where it stepped (rebuilding them
    from the moments, as for JAX, would leave a residue of ~1e-10 where the
    gradient is exactly 0: torch's AdamW takes the moment by ``lerp``, not
    as 0.9 mu + 0.1 g), else from the first moments."""
    if part in out[step]["grads"]:
        return out[step]["grads"][part]
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


def record(agent, state, metrics, jstate, jmetrics, draws, grads) -> dict:
    """One update of both agents, as numpy; ``grads`` holds what the port's
    optimizers took in it."""
    out = dict(
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
        grads=dict(grads),
    )
    grads.clear()
    return out


def start(cfg):
    """The JAX agent and its step-0 state, the port's agent on the same
    state, and a dict that takes each port optimizer's clipped gradients
    (partition -> numpy arrays) when it steps."""
    jagent = jax_agent(cfg)
    jstate = jax_train_state(cfg)
    agent = DiffusionStateAgent(
        OBS_DIM, ACT_DIM, port_config(cfg), port_config(TrainingConfig()), device=CPU
    )
    state = train_state_from_jax(agent, numpy_tree(jstate))
    grads = {}
    for part, opt in state.optimizers.items():
        opt.adamw.register_step_pre_hook(
            lambda adamw, args, kwargs, part=part, params=opt.params: grads.__setitem__(
                part, [q.grad.detach().numpy().copy() for q in params]))
    return jagent, [jstate], agent, state, grads


@pytest.fixture(scope="module")
def steps():
    """Two chained updates of both agents from one state and batch each."""
    jagent, jstates, agent, state, grads = start(train_config())
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
        out.append(record(agent, state, metrics, jstate, jmetrics, draws, grads))
        out[-1].update(batch=batch, draws=draws)
    return agent, jstates, out


@pytest.fixture(scope="module")
def epoch():
    """Three chained calls of the port's ``train_epoch`` of one update each,
    over a device ring on the CPU, against the JAX ``train_epoch``'s scan
    body on the same transitions: ``replay_sample`` on ``fold_in(k, 0)``,
    then the JAX train step (the program ``steps`` compiles). The port's
    ring indices are JAX's ``randint`` draw on that key, its update's draws
    ``draws_from_jax``."""
    jagent, jstates, agent, state, grads = start(train_config())
    rng = np.random.default_rng(7)
    data = (normal(70, 20, OBS_DIM), np.tanh(normal(71, 20, ACT_DIM)), 2.0 * normal(72, 20),
            normal(73, 20, OBS_DIM), rng.random(20) < 0.25)
    jring = jreplay.replay_add_batch(jreplay.replay_init(RING, (OBS_DIM,), ACT_DIM),
                                     *(jnp.asarray(x) for x in data))
    ring = DeviceReplayBuffer(RING, (OBS_DIM,), ACT_DIM, device=CPU)
    ring.add_batch(*data)
    pending = []
    agent.draw_update = lambda state, replay_state, batch_size: pending.pop(0)
    out = []
    for u in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(60 + u), 0)
        indices = jax.random.randint(key, (B,), 0, jnp.maximum(jring.size, 1))
        jbatch = jreplay.replay_sample(jring, key, B)
        jbatch["dones"] = jbatch["dones"].astype(jnp.float32)  # the program's input type
        draws = draws_from_jax(jagent, jstates[-1], B)
        jstate, jmetrics = jax_train_step(jagent, jstates[-1], jbatch)
        jstates.append(jstate)
        pending.append((torch.from_numpy(np.asarray(indices, np.int64)), draws))
        state, metrics = agent.train_epoch(state, ring.state, 1)
        assert not pending and agent.total_steps == u + 1
        out.append(record(agent, state, metrics, jstate, jmetrics, draws, grads))
    return agent, jstates, out


@pytest.mark.parametrize("step", [0, 1], ids=["step0-with-mine", "step1-without-mine"])
def test_train_step_matches_jax_agent(steps, step):
    check_update(*steps, step)


@pytest.mark.parametrize("step", [0, 1, 2], ids=["update0-with-mine", "update1", "update2"])
def test_train_epoch_matches_jax_scan_body(epoch, step):
    check_update(*epoch, step)


def step_core(jstates, **groups_from):
    """A port core on the CPU with the parameters of JAX state 1 (after
    step 0), but the groups named in ``groups_from`` taken from the JAX
    state of that index."""
    params = dict(jstates[1].params)
    for group, index in groups_from.items():
        params[group] = jstates[index].params[group]
    return torch_core(train_config(), numpy_tree(params))


@pytest.mark.parametrize("module", ["elbo_terms", "expected_free_energy", "mine_estimate"])
def test_step_modules_match_jax(steps, module):
    """Each training module of the port on the JAX train step's own inputs
    at step 0 (its state, batch and draws, and the parameters the module
    sees inside the step), against what that step returns, at
    ``MODEL_TOL``: the ELBO terms (the parameters before the step) and the
    time-importance update; the EFE and its terms as the policy loss and
    ``efe/`` metrics (the model as the step updated it, the policy and value
    before their updates); the MINE bound and running mean (the dynamics and
    decoder as updated, the estimator before its update)."""
    _, jstates, out = steps
    first = out[0]
    jmetrics, draws, batch = first["jmetrics"], first["draws"], first["batch"]
    core = step_core(jstates, **{g: 0 for g in jstates[0].params})  # the state before the step
    obs, next_obs = t(batch["observations"]), t(batch["next_observations"])
    latent = core.beliefs_from_start(torch.cat([obs, next_obs]), draws.belief_noise,
                                     draws.belief_seed, deterministic=True,
                                     compute_reconstruction=False).latent[:B]
    if module == "elbo_terms":
        norm = jstates[0].reward_norm
        rewards = t(batch["rewards"])
        reward_norm = RewardNormState(*(torch.tensor(np.asarray(x)) for x in
                                        (norm.mean, norm.var, norm.count))).update(rewards)
        with torch.enable_grad():
            terms = core.elbo_terms(obs, reward_norm.normalize(rewards), latent, draws.elbo)
        got = {k: terms[k] for k in ("reconstruction_loss", "kl_loss", "score_matching_loss",
                                     "grad_penalty", "reward_loss", "mean_time",
                                     "loss_weight_mean")}
        got["elbo"] = core.elbo_value(terms)
        importance = update_time_importance(t(jstates[0].time_importance), terms["t"],
                                            terms["per_sample_score_losses"].detach())
        got_state, want_state = importance, jstates[1].time_importance
    elif module == "expected_free_energy":
        core = step_core(jstates, policy=0, value=0, epistemic=0)
        with torch.no_grad():
            efe, info = core.compute_expected_free_energy(
                latent, torch.tensor(np.asarray(jstates[0].preference_temperature)), draws.efe)
        got = {"policy_loss": efe.mean(), **info}
        got_state = want_state = None
    else:
        core = step_core(jstates, epistemic=0)
        with torch.no_grad():
            mean, logvar = core.predict_next_latent(latent, t(batch["actions"]))
            result = estimate_epistemic_value(
                core.epistemic_estimator, lambda z: core.decode_observation(z), mean, logvar,
                draws.mine, torch.tensor(np.asarray(jstates[0].epistemic_running_mean)))
        got = {"epistemic_mi": result.mi_lower_bound}
        got_state, want_state = result.running_mean, jstates[1].epistemic_running_mean
    for name, value in got.items():
        np.testing.assert_allclose(value.detach().numpy(), jmetrics[name], err_msg=name,
                                   **MODEL_TOL)
    if want_state is not None:
        np.testing.assert_allclose(got_state.detach().numpy(), np.asarray(want_state),
                                   **MODEL_TOL)


def check_update(agent, jstates, out, step):
    """Update ``step`` of ``out`` against the JAX agent's, by the rules of
    this file's docstring."""
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
