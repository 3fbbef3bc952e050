"""Port parity: the acting slice as a whole, and the port's guards.

The JAX agent's ``act(state, obs, key, deterministic=True, collect=False)``
with ``deterministic_beliefs=True`` is compared with the port's
``act_from_start`` on JAX's own start latent, recomputed here from the key
path (``_act_impl`` splits the key in 3, ``core.act`` splits ``act_key`` in
3, ``generate_beliefs`` splits ``belief_key`` in 2 and draws z0 from the
first half), at rtol 1e-4 / atol 1e-5.
"""

import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.agents.state_agent import (
    DiffusionStateAgent as JaxStateAgent,
)
from active_inference_diffusion_tpu.configs.config import (
    BeliefDynamicsConfig,
    TrainingConfig,
)
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.core.active_inference import check_sweep_supported
from torch_parity import (
    ACT_DIM,
    MODEL_TOL,
    OBS_DIM,
    B,
    D,
    jax_core_and_params,
    normal,
    t,
    tiny_config,
    torch_core,
)

REPO = Path(__file__).resolve().parents[1]
SEED = torch.tensor(0, dtype=torch.int64)


def jax_start_latent(key, batch):
    _, act_key, _ = jax.random.split(key, 3)
    belief_key, _, _ = jax.random.split(act_key, 3)
    init_key, _ = jax.random.split(belief_key)
    return np.asarray(jax.random.normal(init_key, (batch, D), dtype=jnp.float32))


def torch_agent(cfg, params, training_config=None):
    agent = DiffusionStateAgent(OBS_DIM, ACT_DIM, cfg, training_config or TrainingConfig())
    agent.load_jax_params(params)
    return agent


# policy_squash None resolves to tanh (corrected mode); False leaves the
# Gaussian mean unsquashed, so the clip to [-1, 1] is exercised too.
@pytest.mark.parametrize("policy_squash", [None, False], ids=["tanh", "unsquashed"])
def test_act_matches_jax_agent(policy_squash):
    cfg = tiny_config(deterministic_beliefs=True, policy_squash=policy_squash)
    _, params = jax_core_and_params(cfg)
    obs = 2.0 * normal(20, B, OBS_DIM)
    key = jax.random.PRNGKey(21)
    jagent = JaxStateAgent(OBS_DIM, ACT_DIM, cfg, TrainingConfig())
    # act reads only state.params when no EMA acting flag is set
    expected = jagent.act(
        types.SimpleNamespace(params=params), obs, key, deterministic=True, collect=False
    )
    got = torch_agent(cfg, params).act_from_start(
        t(obs), t(jax_start_latent(key, B)), SEED, None, deterministic=True
    )
    if policy_squash is False:
        assert (np.abs(expected) == 1.0).any()  # some actions were clipped
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-4, atol=1e-5)


def test_beliefs_match_jax_generate_beliefs():
    cfg = tiny_config()
    jcore, params = jax_core_and_params(cfg)
    tcore = torch_core(cfg, params)
    obs = normal(22, B, OBS_DIM)
    key = jax.random.PRNGKey(23)
    z0 = np.asarray(jax.random.normal(jax.random.split(key)[0], (B, D), dtype=jnp.float32))
    for batch in (B, 1):  # ddof=1 std; zeros at batch 1
        expected = jcore.generate_beliefs(
            params, key, obs[:batch], deterministic=True, compute_reconstruction=False
        )
        got = tcore.beliefs_from_start(t(obs[:batch]), t(z0[:batch]), SEED, deterministic=True)
        for name in ("latent", "latent_mean", "latent_std"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(expected, name)),
                err_msg=name, **MODEL_TOL,
            )
        assert got.trajectory is None


def test_agent_act_on_cpu():
    cfg = tiny_config()
    _, params = jax_core_and_params(cfg)
    agent = torch_agent(cfg, params, TrainingConfig(collect_diffusion_steps=3))
    obs = normal(24, 6, OBS_DIM)
    actions = agent.act(obs, torch.Generator().manual_seed(0), deterministic=False, collect=True)
    assert actions.shape == (6, ACT_DIM) and actions.dtype == np.float32
    assert np.isfinite(actions).all() and (np.abs(actions) <= 1.0).all()
    # collect=True runs collect_diffusion_steps: replay the same draws
    g = torch.Generator().manual_seed(0)
    z0, seed = agent.core.draw_start(6, g)
    again = agent.act_from_start(t(obs), z0, seed, g, deterministic=False, num_steps=3)
    np.testing.assert_array_equal(actions, again.numpy())
    # one observation -> a batch of one
    single = agent.act(obs[0], torch.Generator().manual_seed(1), deterministic=True)
    assert single.shape == (1, ACT_DIM)


@pytest.mark.parametrize(
    "overrides,call",
    [
        (dict(posterior_beliefs=True, act_from_posterior=True), "act"),
        (dict(plan_candidates=4), "act"),
        (dict(belief_dynamics=BeliefDynamicsConfig(use_belief_dynamics=True)), "act"),
        ({}, "compute_efe_info"),
        ({}, "return_trajectory"),
        ({}, "act_warm"),
        (dict(pixel_observation=True), "construct"),
    ],
    ids=["act_from_posterior", "act_planned", "belief_dynamics", "efe_info",
         "trajectory", "act_warm", "pixels"],
)
def test_unported_branches_raise(overrides, call):
    cfg = tiny_config(**overrides)
    obs = normal(25, 2, OBS_DIM)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        agent = DiffusionStateAgent(OBS_DIM, ACT_DIM, cfg, TrainingConfig())
        if call == "act":
            agent.act(obs, g)
        elif call == "compute_efe_info":
            agent.core.act(g, t(obs), compute_efe_info=True)
        elif call == "return_trajectory":
            agent.core.generate_beliefs(g, t(obs), return_trajectory=True)
        elif call == "act_warm":
            agent.act_warm(obs, g)


@pytest.mark.parametrize(
    "field,value", [("compute_dtype", "bfloat16"), ("denoiser_kernel", "v2")]
)
def test_cuda_only_sweep_variants_raise(field, value):
    cfg = tiny_config()
    setattr(cfg.tpu, field, value)
    check_sweep_supported(cfg, torch.device("cpu"))  # the plain f32 sweep runs
    with pytest.raises(NotImplementedError):
        check_sweep_supported(cfg, torch.device("cuda"))


def test_port_imports_no_jax():
    """Importing the port, building the agent and acting on the CPU loads
    neither jax nor flax."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "from active_inference_diffusion_torch import (ActiveInferenceConfig,\n"
        "    DiffusionConfig, DiffusionStateAgent, TrainingConfig)\n"
        "cfg = ActiveInferenceConfig(observation_dim=5, action_dim=2, latent_dim=8,\n"
        "    hidden_dim=32, score_num_layers=2,\n"
        "    diffusion=DiffusionConfig(num_diffusion_steps=5))\n"
        "agent = DiffusionStateAgent(5, 2, cfg, TrainingConfig())\n"
        "a = agent.act(np.zeros((3, 5), np.float32), torch.Generator().manual_seed(0))\n"
        "assert a.shape == (3, 2) and np.isfinite(a).all()\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax'))\n"
        "assert not loaded, loaded\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
