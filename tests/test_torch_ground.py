"""Port parity: grounded-belief training (``ground_beliefs``, the flag of
``examples/configs/halfcheetah_state_tuned.yaml``), the trajectory sweep,
``generate_latents`` and the policy's decaying learning rate.

- The train update with ``ground_beliefs`` and stochastic beliefs: the
  belief sweep over observations and next observations runs inside the
  fused score+model loss (``scan_beliefs``, the JAX core's scan), so the
  reconstruction, KL and reward gradients reach the score network through
  every denoising step. Two chained ``train_step``s and three chained
  ``train_epoch`` updates against ONE compiled JAX ``_train_step_impl``
  (``chained_steps``, ``chained_epochs``; the JAX side once per test run),
  on the JAX step's draws, the sweep's start and each step's noise among
  them (``draws_from_jax``), by ``check_update``'s rules: metrics and state
  fields at ``MODEL_TOL``, gradients as Adam's first moments at
  ``GRAD_RTOL`` / ``GRAD_ATOL`` of the partition's largest, parameters at
  ``MODEL_TOL`` plus Adam's sign rule.
- The gradient flow of ``tests/test_agent_train.py:340-372``, mirrored: the
  reconstruction loss of grounded latents has a nonzero gradient in the
  score network; of stop-gradient latents exactly 0.
- ``generate_beliefs(return_trajectory=True)`` (the plain scan, which the
  JAX core never gives its kernel) and ``core/diffusion.py::generate_latents``
  against JAX on the JAX keys' draws: the start and every step's latents,
  the belief's mean, standard deviation and reconstruction error, at
  ``MODEL_TOL``.
- ``policy_lr_decay_steps``: the policy partition's rate at every update
  across the decay's end against ``optax.cosine_decay_schedule`` on the
  optimizer's count, as the optimizer's step writes it and as the schedule
  gives it, at rtol 1e-6 (float32 against optax's float32, which rounds the
  same formula differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from active_inference_diffusion_tpu.core import diffusion as jdiffusion
from active_inference_diffusion_torch.agents.base import CosineDecay, make_optimizers
from active_inference_diffusion_torch.core import diffusion as tdiffusion
from torch_parity import (
    MODEL_TOL,
    OBS_DIM,
    B,
    D,
    K,
    chained_epochs,
    chained_steps,
    check_update,
    ground_config,
    jax_core_and_params,
    normal,
    port_config,
    t,
    tiny_config,
    torch_agent,
    torch_core,
)

RATE_RTOL = 1e-6


@pytest.mark.parametrize("step", [0, 1], ids=["step0-with-mine", "step1-without-mine"])
def test_ground_train_step_matches_jax_agent(step):
    agent, jstates, out = chained_steps(ground_config())
    draws = out[step]["draws"]
    assert draws.sweep_noise.shape == (K, 2 * B, D)
    check_update(agent, jstates, out, step)


@pytest.mark.parametrize("step", [0, 1, 2], ids=["update0-with-mine", "update1", "update2"])
def test_ground_train_epoch_matches_jax_scan_body(step):
    check_update(*chained_epochs(ground_config()), step)


def test_ground_gradient_flow():
    """The reconstruction loss of the grounded sweep's latents reaches the
    score network (every trunk weight of the score group gets a gradient
    somewhere); through stop-gradient latents its gradient is exactly 0.
    The train update's own draws: grounded beliefs draw every sweep step's
    noise, deterministic ones none."""
    cfg = ground_config()
    _, params = jax_core_and_params(cfg)
    core = torch_core(cfg, params)
    obs = t(normal(40, B, OBS_DIM))
    z0, noise = t(normal(41, B, D)), t(normal(42, K, B, D))
    net = core.score_network

    def recon_grads(ground: bool):
        latent = core.scan_beliefs(obs, z0, noise).latent
        if not ground:
            latent = latent.detach()
        loss = torch.mean((core.decode_observation(latent) - obs) ** 2)
        grads = torch.autograd.grad(loss, list(net.parameters()), allow_unused=True)
        return sum(0.0 if g is None else float(g.abs().sum()) for g in grads)

    assert recon_grads(True) > 0.0
    assert recon_grads(False) == 0.0
    agent = torch_agent(cfg, params)
    draws = agent.draw_train(agent.new_train_state(0), B)
    assert draws.sweep_noise.shape == (K, 2 * B, D)
    cfg.deterministic_beliefs = True
    agent = torch_agent(cfg, params)
    assert agent.draw_train(agent.new_train_state(0), B).sweep_noise is None


def test_ground_and_posterior_beliefs_are_exclusive():
    cfg = tiny_config(ground_beliefs=True, posterior_beliefs=True)
    with pytest.raises(ValueError, match="exclusive"):
        torch_agent(cfg, jax_core_and_params()[1])


def jax_normal(key, *shape):
    return np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))


@pytest.mark.parametrize(
    "case", ["full", "partial", "warm", "deterministic"],
)
def test_generate_beliefs_trajectory_matches_jax(case):
    """The JAX core's ``generate_beliefs(return_trajectory=True)`` and the
    port's scan on the JAX key's draws (the key split into the start's and
    the scan's; the scan's split per step), with the full schedule, a
    partial sweep of 3 steps, a warm start from previous latents (forward
    noised to the truncation step) and a deterministic sweep; then the
    port's own ``generate_beliefs`` returns the start and each step."""
    cfg = tiny_config()
    jcore, params = jax_core_and_params(cfg)
    core = torch_core(cfg, params)
    obs = normal(43, B, OBS_DIM)
    steps = 3 if case in ("partial", "warm") else K
    deterministic = case == "deterministic"
    prev = normal(44, B, D) if case == "warm" else None
    key = jax.random.PRNGKey(45)
    want = jcore.generate_beliefs(params, key, jnp.asarray(obs), num_steps=steps,
                                  deterministic=deterministic, return_trajectory=True,
                                  z_init=None if prev is None else jnp.asarray(prev))
    init_key, scan_key = jax.random.split(key)
    start = t(jax_normal(init_key, B, D))
    noise = t(np.stack([jax_normal(k, B, D) for k in jax.random.split(scan_key, steps)]))
    with torch.no_grad():
        z0 = core.warm_start(start, steps, None if prev is None else t(prev))
        result = core.scan_beliefs(t(obs), z0, noise, steps, deterministic,
                                   return_trajectory=True)
        got = core._belief_info(result.latent, t(obs), True, result.trajectory)
    assert got.trajectory.shape == (steps + 1, B, D)
    for name in ("trajectory", "latent", "latent_mean", "latent_std", "reconstruction_error"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **MODEL_TOL)
    own = core.generate_beliefs(torch.Generator().manual_seed(0), t(obs), num_steps=steps,
                                return_trajectory=True)
    assert own.trajectory.shape == (steps + 1, B, D)
    assert torch.equal(own.trajectory[-1], own.latent)


@pytest.mark.parametrize("deterministic", [False, True], ids=["stochastic", "deterministic"])
def test_generate_latents_matches_jax(deterministic):
    """``generate_latents`` with the score network (discrete time embedding,
    the observation) as its score function, on the JAX key's draws; its
    trajectory and final latent."""
    cfg = tiny_config()
    jcore, params = jax_core_and_params(cfg)
    core = torch_core(cfg, params)
    obs = normal(46, B, OBS_DIM)
    key = jax.random.PRNGKey(47)

    def jax_score(z, time, observation):
        return jcore.score_network.apply({"params": params["score"]}, z, time, observation,
                                         continuous=False)

    want = jdiffusion.generate_latents(jcore.schedule, jax_score, key, B, D,
                                       observation=jnp.asarray(obs), deterministic=deterministic,
                                       return_trajectory=True)
    init_key, scan_key = jax.random.split(key)
    noise = None if deterministic else t(np.stack(
        [jax_normal(k, B, D) for k in jax.random.split(scan_key, K)]))
    with torch.no_grad():
        got = tdiffusion.generate_latents(
            core.schedule, lambda z, time, o: core.score_network(z, time, o, continuous=False),
            t(jax_normal(init_key, B, D)), noise, observation=t(obs),
            deterministic=deterministic, return_trajectory=True)
    np.testing.assert_allclose(got.trajectory.numpy(), np.asarray(want.trajectory), **MODEL_TOL)
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), **MODEL_TOL)


@pytest.mark.parametrize("form", ["optimizer-step", "schedule"])
def test_policy_rate_schedule_matches_optax(form):
    """The policy partition with ``policy_lr_decay_steps`` 3 and final scale
    0.1: its rate at updates 0-5 (across the decay's end), as
    ``PartitionOptimizer.step`` writes it from AdamW's count before each
    update, and as ``CosineDecay`` gives it of a float32 count tensor,
    against optax's schedule on the same count; the other partitions keep
    a constant rate."""
    jcfg = tiny_config(policy_lr_decay_steps=3, policy_lr_final_scale=0.1, policy_lr_scale=0.5)
    cfg = port_config(jcfg)
    want = optax.cosine_decay_schedule(cfg.learning_rate * cfg.policy_lr_scale, 3, 0.1)
    agent = torch_agent(jcfg, jax_core_and_params()[1])
    opts = make_optimizers(cfg, agent.PARTITIONS, agent.core)
    policy = opts["policy"]
    assert all(opts[name].lr is None for name in opts if name != "policy")
    assert isinstance(policy.schedule, CosineDecay)
    assert policy.adamw.param_groups[0]["lr"] is policy.lr
    for count in range(6):
        if form == "optimizer-step":
            policy.step([torch.zeros_like(p) for p in policy.params])
            got = float(policy.lr)
        else:
            got = float(policy.schedule(torch.tensor(float(count))))
        np.testing.assert_allclose(got, float(want(count)), rtol=RATE_RTOL,
                                   err_msg=f"update {count}")
