"""Port parity: the learning presets (examples/configs/*_state_dreamer.yaml).

The presets' ``active_inference`` flags, read from the YAML files, at the
tiny widths of tests/torch_parity.py (``dreamer_config``): posterior
beliefs and posterior acting, the imagined lambda actor-critic over a
dynamics ensemble of 5 with the slow critic, return normalisation and
auto-tuned entropy; Hopper adds the continuation head, the policy anchor
and the EMA policy (its anchor warm-up cut to 1 step here, so the gate
opens between the two chained steps and inside the epoch).

Every draw is the JAX program's own, rebuilt from its keys: the posterior's
eps is a normal on the belief key; the imagined objective splits each
step's key in 2 (policy, dynamics), the EFE in 3; an ensemble member is
``randint(fold_in(dynamics key, 1), (n,), 0, K)``.

Tolerances: float32 modules that differ only in summation order at
``MODEL_TOL`` (rtol 2e-4 / atol 2e-5); the actions of an act call at rtol
1e-4 / atol 1e-5; gradients as in tests/test_torch_train.py (rtol 2e-4,
atol 2e-5 times the largest); whole train updates by that file's rules
(``check_update``). The train state's EMAs, return scale and log_alpha are
moved off their initial values, so every field is exercised.
"""

import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from active_inference_diffusion_tpu.configs.config import (
    BeliefDynamicsConfig,
    SemanticsConfig,
    TrainingConfig,
)
from active_inference_diffusion_torch import load_yaml_config
from active_inference_diffusion_torch.agents.base import clip_by_global_norm
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.bridge import (
    group_arrays,
    load_jax_params,
    train_state_from_jax,
)
from active_inference_diffusion_torch.core.active_inference import ActStart, EfeDraws
from torch_parity import (
    ACT_DIM,
    CPU,
    MODEL_TOL,
    OBS_DIM,
    B,
    D,
    GRAD_ATOL,
    GRAD_RTOL,
    _cached,
    _config_key,
    adam_mu,
    chained_epochs,
    chained_steps,
    check_update,
    digest,
    efe_draws,
    fast_jit,
    jax_agent,
    jax_train_state,
    normal,
    numpy_tree,
    perturbed,
    port_config,
    shared,
    t,
    tiny_config,
    to_torch,
    torch_core,
    train_config,
)

REPO = Path(__file__).resolve().parents[1]
PRESETS = ("halfcheetah", "hopper", "walker2d")
ACT_TOL = dict(rtol=1e-4, atol=1e-5)
SEED = torch.tensor(0, dtype=torch.int64)
REFINE = BeliefDynamicsConfig(use_belief_dynamics=True, refine_steps=2)


def preset_path(preset: str) -> Path:
    return REPO / "examples" / "configs" / f"{preset}_state_dreamer.yaml"


def dreamer_config(preset: str, **overrides):
    """The preset's ``active_inference`` flags at the tiny widths: its
    widths, batch size, schedule and environment are left out."""
    section = yaml.safe_load(preset_path(preset).read_text())["active_inference"]
    for key in ("latent_dim", "hidden_dim", "batch_size", "diffusion", "env_name"):
        section.pop(key)
    section["semantics"] = SemanticsConfig(**section["semantics"])
    if section.get("policy_anchor_weight", 0) > 0:
        section["policy_anchor_warmup_steps"] = 1
    return tiny_config(**{**section, **overrides})


def dreamer_state(preset: str):
    """The JAX step-0 state (``jax_train_state``) of the preset's
    ``dreamer_config``, with its score EMA, slow critic and (where the
    preset keeps one) EMA policy perturbed away from the live networks,
    return scale 1.6 and log_alpha 0.3 above its start. Any config of the
    same widths and ensemble may use it."""
    def build():
        cfg = dreamer_config(preset)
        state = jax_train_state(dreamer_config("halfcheetah"))  # the presets' shapes agree
        params = state.params
        keeps_policy = cfg.policy_anchor_weight > 0 or cfg.act_with_policy_ema
        return state.replace(
            ema_score=perturbed(params["score"], 11), target_value=perturbed(params["value"], 12),
            ema_policy=perturbed(params["policy"], 13) if keeps_policy else None,
            return_scale=jnp.float32(1.6), log_alpha=state.log_alpha + jnp.float32(0.3),
        )

    return _cached(("dreamer_state", preset), build)


def port_agent_and_state(cfg, jstate, training_config=None):
    agent = DiffusionStateAgent(OBS_DIM, ACT_DIM, port_config(cfg),
                                port_config(training_config or TrainingConfig()), device=CPU)
    return agent, train_state_from_jax(agent, numpy_tree(jstate))


def jax_normal(key, *shape):
    return np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))


def posterior_start(key, batch, refine_steps=0, warm=False):
    """The draws of the JAX agent's ``act`` (or ``act_warm``) with
    ``act_from_posterior`` as the port's ``ActStart``: the posterior's eps on
    the belief key, and the refinement's normals from the act key."""
    if warm:
        _, belief_key, act_key, _, _ = jax.random.split(key, 5)
    else:
        _, agent_act_key, _ = jax.random.split(key, 3)
        belief_key, _, act_key = jax.random.split(agent_act_key, 3)
    refine_noise = None
    if refine_steps:
        fp_key, _ = jax.random.split(act_key)
        refine_noise = t(np.stack([jax_normal(k, batch, D)
                                   for k in jax.random.split(fp_key, refine_steps)]))
    return ActStart(t(jax_normal(belief_key, batch, D)), SEED, refine_noise)


def rollout_draws(cfg, key, batch, parts):
    return EfeDraws(**to_torch(efe_draws(cfg, key, batch, parts)))


# -- the modules -------------------------------------------------------------


def objective_config():
    """HalfCheetah's flags with the imagined objective's other branches:
    stochastic imagination, the fixed entropy scale, no return norm."""
    return dreamer_config("halfcheetah", imagine_deterministic=False, auto_entropy=False,
                          imagined_return_norm=False)


def jax_modules(params):
    """In one compiled program, with the port's inputs for each: the JAX
    posterior encoder on unit and low-variance observations, a posterior
    sample, one imagination step over the ensemble (HalfCheetah's flags),
    and the imagined objective with its policy gradient
    (``objective_config``, the live critic)."""
    jcore = jax_agent(dreamer_config("halfcheetah")).core
    objective_core = jax_agent(objective_config()).core
    obs = normal(30, B, OBS_DIM)
    inputs = dict(unit=obs, low=0.3 + 1e-3 * obs, z=normal(32, B, D),
                  a=np.tanh(normal(33, B, ACT_DIM)), latent=normal(35, B, D))
    key, objective_key = jax.random.PRNGKey(34), jax.random.PRNGKey(36)

    def objective(policy, params):
        loss, imagined, info = objective_core.imagined_lambda_objective(
            dict(params, policy=policy), inputs["latent"], objective_key, jnp.float32(1.3))
        return loss, (imagined, info)

    def run(params):
        return dict(
            unit=jcore.apply_posterior(params["posterior"], inputs["unit"]),
            low=jcore.apply_posterior(params["posterior"], inputs["low"]),
            sample=jcore.sample_posterior(params["posterior"], key, inputs["unit"]),
            sample_std=jnp.std(jcore.sample_posterior(params["posterior"], key, inputs["unit"]),
                               axis=0),
            eps=jax.random.normal(key, (B, D)),
            imagined=jcore.imagine_next(params["dynamics"], inputs["z"], inputs["a"], key),
            members=jax.random.randint(jax.random.fold_in(key, 1), (B,), 0, 5),
            objective=jax.value_and_grad(objective, has_aux=True)(params["policy"], params),
        )

    want = shared(("modules", digest(params)), lambda: numpy_tree(fast_jit(run)(params)))
    inputs["objective_draws"] = rollout_draws(objective_config(), objective_key, B, 2)
    return want, inputs


@pytest.mark.parametrize("case", ["posterior-unit", "posterior-low-variance",
                                  "sample-posterior", "imagine-next", "imagined-objective"])
def test_modules_match_jax(case):
    """``LatentPosteriorEncoder`` (mu and the clipped logstd) on unit and
    on low-variance inputs (the LayerNorm's eps, 1e-6, shows there);
    ``sample_posterior`` mu + exp(logstd) eps on the JAX key's eps, and the
    act path's ``posterior_beliefs`` with its ddof-0 standard deviation; one
    ``imagine_next`` step over the ensemble of 5, each row's member the JAX
    key's (``fold_in(key, 1)``): the mean, the fixed log-variance and the
    disagreement (the members' ddof-0 std averaged over dims);
    ``imagined_lambda_objective`` on the branches the presets leave off
    (``objective_config``): the actor loss, the seven ``imagined/*``
    metrics, the critic's states, times and lambda-returns, and the policy
    gradient. The presets' own branches of the objective (the slow critic,
    the return scale, exp(log_alpha); with and without the continuation
    head) are held on the train step's own inputs
    (``check_actor_on_the_step_inputs``)."""
    params = dreamer_state("halfcheetah").params
    want, inputs = jax_modules(params)
    if case == "imagined-objective":
        check_objective(want["objective"], inputs, params)
        return
    tcore = torch_core(dreamer_config("halfcheetah"), params)
    with torch.no_grad():
        if case == "sample-posterior":
            belief = tcore.posterior_beliefs(t(inputs["unit"]), t(want["eps"]))
            got = [tcore.sample_posterior(t(inputs["unit"]), t(want["eps"])), belief.latent,
                   belief.latent_std]
            expected = [want["sample"], want["sample"], want["sample_std"]]
        elif case == "imagine-next":
            members = torch.from_numpy(want["members"].astype(np.int64))
            assert len(set(members.tolist())) > 1
            got = tcore.imagine_next(t(inputs["z"]), t(inputs["a"]), members)
            expected = want["imagined"]
        else:
            which = "unit" if case == "posterior-unit" else "low"
            got, expected = tcore.apply_posterior(t(inputs[which])), want[which]
            assert float(got[1].min()) >= -6.0 and float(got[1].max()) <= 2.0
    for i, (g, w) in enumerate(zip(got, expected)):
        np.testing.assert_allclose(g.numpy(), w, err_msg=f"output {i}", **MODEL_TOL)


def check_objective(want, inputs, params):
    (loss, (imagined, info)), grads = want
    core = torch_core(objective_config(), params)
    got_loss, got_imagined, got_info = core.imagined_lambda_objective(
        t(inputs["latent"]), inputs["objective_draws"], torch.tensor(1.3))
    np.testing.assert_allclose(got_loss.detach().numpy(), loss, **MODEL_TOL)
    assert set(got_info) == set(info)
    for name, value in info.items():
        np.testing.assert_allclose(got_info[name].numpy(), value, err_msg=name, **MODEL_TOL)
    for name, g, w in zip(("states", "times", "returns"), got_imagined, imagined):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **MODEL_TOL)
    got_grads = torch.autograd.grad(got_loss, list(core.policy_network.parameters()))
    want_grads = group_arrays(core.policy_network, grads, "policy")
    scale = max(float(np.abs(w).max()) for w in want_grads.values())
    for (name, _), g in zip(core.policy_network.named_parameters(), got_grads):
        np.testing.assert_allclose(g.numpy(), want_grads[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)


# -- acting ------------------------------------------------------------------


def acting_config(refine: bool = False, deterministic_beliefs: bool = True):
    """Hopper's flags with ``use_ema_for_act`` on as well: posterior acting
    with the EMA policy (and the score EMA, which the posterior path does
    not read)."""
    extra = dict(belief_dynamics=REFINE) if refine else {}
    return dreamer_config("hopper", use_ema_for_act=True,
                          deterministic_beliefs=deterministic_beliefs, **extra)


def jax_acting_state(jstate):
    return types.SimpleNamespace(params=jstate.params, ema_score=jstate.ema_score,
                                 ema_policy=jstate.ema_policy)


@pytest.mark.parametrize("case", ["eval", "stochastic-belief-refined", "warm", "efe-info"])
def test_act_from_posterior_matches_jax(case):
    """Posterior acting with the EMA policy (``act_with_policy_ema``),
    deterministic actions: the JAX agent's ``act`` against the port's on
    the same state, eval (the posterior mean) and with a sampled belief and
    two Fokker-Planck refinement steps; ``act_warm``, whose previous latents
    play no part; and the core's ``act`` with ``compute_efe_info``: the EFE
    over the ensemble on the EFE key's draws, the decoded belief's error."""
    cfg = acting_config(refine=case == "stochastic-belief-refined",
                        deterministic_beliefs=case != "stochastic-belief-refined")
    jstate = dreamer_state("hopper")
    jagent = jax_agent(cfg, TrainingConfig(collect_diffusion_steps=3))
    agent, state = port_agent_and_state(cfg, jstate, TrainingConfig(collect_diffusion_steps=3))
    obs, key = normal(40, B, OBS_DIM), jax.random.PRNGKey(41)
    steps = cfg.belief_dynamics.refine_steps if cfg.belief_dynamics.use_belief_dynamics else 0
    if case == "efe-info":
        params = dict(jstate.params, policy=jstate.ema_policy)
        act = _cached(("posterior_efe", _config_key(cfg)), lambda: jax.jit(functools.partial(
            jagent.core.act, deterministic=True, compute_efe_info=True)))
        actions, info = act(params, key, obs)
        belief_key, efe_key, _ = jax.random.split(key, 3)
        start = ActStart(t(jax_normal(belief_key, B, D)), SEED, None)
        with agent.core.swapped(agent.acting_modules(state)):
            got, got_info = agent.core.act_from_start(
                t(obs), start, None, deterministic=True, efe=rollout_draws(cfg, efe_key, B, 3))
        assert set(got_info) == set(info) and "expected_free_energy" in info
        for name, value in info.items():
            np.testing.assert_allclose(got_info[name].numpy(), np.asarray(value), err_msg=name,
                                       **MODEL_TOL)
    elif case == "warm":
        prev = normal(42, B, D)
        reset = np.arange(B) % 3 == 0
        actions, latents = jagent.act_warm(jax_acting_state(jstate), obs, key, jnp.asarray(prev),
                                           reset, deterministic=True)
        got, got_latents = agent.act_warm_from_start(
            t(obs), t(prev), torch.from_numpy(reset), t(normal(43, B, D)),
            posterior_start(key, B, warm=True), None, deterministic=True, state=state)
        np.testing.assert_allclose(got_latents.numpy(), np.asarray(latents), **MODEL_TOL)
    else:
        actions = jagent.act(jax_acting_state(jstate), obs, key, deterministic=True,
                             collect=False)
        got, _ = agent.act_from_start(t(obs), posterior_start(key, B, steps), None,
                                      deterministic=True, state=state)
    np.testing.assert_allclose(got.numpy(), np.asarray(actions), **ACT_TOL)
    if case == "eval":  # the live policy gives other actions: the EMA policy acted
        live, _ = agent.core.policy_action(agent.core.sample_posterior(t(obs), None), None, True)
        assert not np.allclose(live.numpy(), np.asarray(actions), **ACT_TOL)


@pytest.mark.parametrize("call", ["act", "act_warm"])
def test_acting_with_the_score_ema_matches_jax(call):
    """C4: with ``use_ema_for_act`` the sweep runs the score network's EMA,
    not the live weights: the JAX agent's ``act`` / ``act_warm`` on a state
    whose EMA differs from the live score network, against the port's on
    the same state (deterministic beliefs, JAX's start draws). Without a
    state the port raises instead of acting with the live weights."""
    from test_torch_act import jax_draws

    cfg = tiny_config(deterministic_beliefs=True, use_ema_for_act=True)
    jstate = jax_train_state(train_config())  # the same widths
    jstate = jstate.replace(ema_score=perturbed(jstate.params["score"], 14))
    jagent = jax_agent(cfg, TrainingConfig(collect_diffusion_steps=3))
    agent, state = port_agent_and_state(cfg, jstate, TrainingConfig(collect_diffusion_steps=3))
    obs, key = normal(44, B, OBS_DIM), jax.random.PRNGKey(45)
    if call == "act":
        actions = jagent.act(jax_acting_state(jstate), obs, key, deterministic=True,
                             collect=False)
        start, _ = jax_draws(key, B)
        got, _ = agent.act_from_start(t(obs), start, None, deterministic=True, state=state)
        live, _ = agent.core.act_from_start(t(obs), start, None, deterministic=True)
        with pytest.raises(ValueError, match="use_ema_for_act"):
            agent.act(obs, torch.Generator().manual_seed(0))
    else:
        prev, reset = normal(46, B, D), np.arange(B) % 4 == 0
        actions, _ = jagent.act_warm(jax_acting_state(jstate), obs, key, jnp.asarray(prev), reset,
                                     deterministic=True)
        start, fresh = jax_draws(key, B, warm=True)
        got, _ = agent.act_warm_from_start(t(obs), t(prev), torch.from_numpy(reset), fresh, start,
                                           None, deterministic=True, num_steps=3, state=state)
        z_init = torch.where(torch.from_numpy(reset)[:, None], fresh, t(prev))
        live, _ = agent.core.policy_action(
            agent.core.belief_latent(t(obs), start, 3, z_init), None, True)
        with pytest.raises(ValueError, match="use_ema_for_act"):
            agent.act_warm(obs, torch.Generator().manual_seed(0), torch.zeros(B, D), reset)
    np.testing.assert_allclose(got.numpy(), np.asarray(actions), **ACT_TOL)
    # the live score network gives other actions, and acting left it as it was
    assert not np.allclose(live.numpy(), np.asarray(actions), **ACT_TOL)
    want = group_arrays(agent.core.score_network, jstate.params["score"], "score")
    for name, p in agent.core.score_network.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[name]), name


# -- the train update --------------------------------------------------------


@pytest.mark.parametrize("preset", ["halfcheetah", "hopper"])
def test_dreamer_training_matches_jax(preset):
    """The preset's flags, one compiled JAX train step (the JAX programs
    are the costly part of these tests, so one test holds everything that
    program serves): two chained ``train_step``s against the JAX agent's,
    every metric (the ``imagined/*`` ones and the anchor's KL), every
    partition's gradients and parameters (the posterior encoder's among the
    model's), the score EMA, the slow critic, the return scale, log_alpha
    and the EMA policy (Hopper's anchor closed at step 0, open at step 1);
    the imagined actor and critic on step 0's own inputs
    (``check_actor_on_the_step_inputs``); then three chained ``train_epoch``
    updates over a ring against the JAX scan body (``chained_epochs``)."""
    cfg, jstate = dreamer_config(preset), dreamer_state(preset)
    agent, jstates, out = chained_steps(cfg, jstate)
    for step in (0, 1):
        check_update(agent, jstates, out, step)
        assert (out[step]["metrics"]["policy_anchor_kl"] != 0) == (preset == "hopper")
        assert out[step]["metrics"]["imagined/return_range"] > 0
    check_actor_on_the_step_inputs(agent, jstates, out)
    epoch = chained_epochs(cfg, jstate)
    for step in range(3):
        check_update(*epoch, step)


def check_actor_on_the_step_inputs(agent, jstates, out):
    """The imagined actor and critic of the presets' flags on the JAX train
    step's own inputs at step 0: the posterior latents from the parameters
    before the step, the model as the step updated it, the policy, slow
    critic, return scale and log_alpha before it. The port's
    ``imagined_lambda_objective`` gives the step's policy loss and
    ``imagined/*`` metrics, its gradient clipped as the optimizer clips it
    gives the policy's first moment (0.1 g), and its lambda-returns give the
    step's value loss; at ``MODEL_TOL`` and the gradient rule."""
    cfg, before = agent.config, jstates[0]
    first = out[0]
    params = dict(jstates[1].params)
    params.update({g: before.params[g] for g in ("policy", "value", "posterior")})
    core = type(agent.core)(OBS_DIM, ACT_DIM, D, cfg, device=CPU)
    load_jax_params(core, numpy_tree(params))
    state = train_state_from_jax(agent, numpy_tree(before))
    obs = t(first["batch"]["observations"])
    latents = core.sample_posterior(obs, first["draws"].belief_noise[:B]).detach()
    loss, (zs, ts, targets), info = core.imagined_lambda_objective(
        latents, first["draws"].efe, state.preference_temperature,
        value_params=state.target_value, return_scale=state.return_scale,
        entropy_scale=torch.exp(state.log_alpha))
    jmetrics = first["jmetrics"]
    np.testing.assert_allclose(loss.detach().numpy(), jmetrics["policy_loss"], **MODEL_TOL)
    for name, value in info.items():
        np.testing.assert_allclose(value.numpy(), jmetrics[name], err_msg=name, **MODEL_TOL)
    params_policy = list(core.policy_network.parameters())
    grads = clip_by_global_norm(torch.autograd.grad(loss, params_policy), cfg.gradient_clip)
    jmu = adam_mu(first["jstate"].opt_states["policy"])
    want = group_arrays(core.policy_network, jmu["policy"], "policy")
    scale = max(float(np.abs(w).max()) for w in want.values())
    for (name, _), g in zip(core.policy_network.named_parameters(), grads):
        np.testing.assert_allclose(0.1 * g.numpy(), want[name], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=name)
    zs, ts, targets = zs.reshape(-1, D), ts.reshape(-1), targets.reshape(-1)
    with torch.no_grad():
        values = core.apply_value(zs, ts)
        slow = core.apply_value(zs, ts, params=state.target_value)
    value_loss = (torch.nn.functional.huber_loss(values, targets)
                  + cfg.value_ema_regularizer * torch.nn.functional.huber_loss(values, slow))
    np.testing.assert_allclose(value_loss.numpy(), jmetrics["value_loss"], **MODEL_TOL)


@pytest.mark.parametrize("preset", ["halfcheetah", "hopper"])
def test_train_state_from_jax_carries_the_new_fields(preset):
    """The slow critic, return scale, log_alpha and EMA policy of a JAX
    state map onto the port's; a state without an EMA policy for a config
    that keeps one raises."""
    cfg = dreamer_config(preset)
    jstate = dreamer_state(preset)
    agent, state = port_agent_and_state(cfg, jstate)
    core = agent.core
    for got, module, tree, group in ((state.target_value, core.value_network,
                                      jstate.target_value, "value"),
                                     (state.ema_score, core.score_network,
                                      jstate.ema_score, "score")):
        want = group_arrays(module, tree, group)
        assert all(np.array_equal(v.numpy(), want[k]) for k, v in got.items())
    assert float(state.return_scale) == pytest.approx(1.6)
    assert float(state.log_alpha) == pytest.approx(float(jstate.log_alpha))
    if jstate.ema_policy is None:
        assert state.ema_policy is None
        return
    want = group_arrays(core.policy_network, jstate.ema_policy, "policy")
    assert all(np.array_equal(v.numpy(), want[k]) for k, v in state.ema_policy.items())
    with pytest.raises(ValueError, match="EMA policy"):
        train_state_from_jax(agent, numpy_tree(jstate.replace(ema_policy=None)))


@pytest.mark.parametrize("preset", PRESETS)
def test_presets_load_and_train_supported(preset):
    """Each preset loaded by the port's own ``load_yaml_config`` from its
    file passes ``check_train_supported`` and builds a train state as the
    JAX agent's (an EMA policy exactly where the anchor or EMA acting wants
    one); faithful semantics still raises, ``ground_beliefs`` trains."""
    cfg, training, _ = load_yaml_config(str(preset_path(preset)))
    assert cfg.posterior_beliefs and cfg.act_from_posterior and cfg.imagined_value_targets
    assert cfg.num_dynamics_ensemble == 5
    cfg.latent_dim, cfg.hidden_dim, cfg.score_num_layers = D, 32, 1
    agent = DiffusionStateAgent(OBS_DIM, ACT_DIM, cfg, training, device=CPU)
    agent.check_train_supported()
    state = agent.new_train_state(0)
    assert (state.ema_policy is not None) == (preset != "halfcheetah")
    assert float(state.log_alpha) == pytest.approx(np.log(3e-4))
    cfg.posterior_beliefs = cfg.act_from_posterior = False
    cfg.ground_beliefs = True
    agent.check_train_supported()
    cfg.semantics.mode = "faithful"
    with pytest.raises(NotImplementedError, match="faithful semantics"):
        agent.check_train_supported()
