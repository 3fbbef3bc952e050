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

import numpy as np
import pytest
import torch

from active_inference_diffusion_torch.agents.base import RewardNormState
from active_inference_diffusion_torch.core.epistemic import estimate_epistemic_value
from active_inference_diffusion_torch.core.time_sampler import update_time_importance
from torch_parity import (
    MODEL_TOL,
    B,
    chained_epochs,
    chained_steps,
    check_update,
    numpy_tree,
    t,
    torch_core,
    train_config,
)


@pytest.fixture(scope="module")
def steps():
    """Two chained updates of both agents from one state and batch each."""
    return chained_steps(train_config())


@pytest.fixture(scope="module")
def epoch():
    """Three chained calls of the port's ``train_epoch`` of one update each
    against the JAX ``train_epoch``'s scan body (``chained_epochs``)."""
    return chained_epochs(train_config())


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
