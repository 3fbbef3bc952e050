"""Port parity: the acting slice as a whole, and the port's guards.

The JAX agent's ``act(state, obs, key, deterministic=True, collect=False)``
and ``act_warm`` with ``deterministic_beliefs=True`` are compared with the
port's ``act_from_start`` / ``act_warm_from_start`` on JAX's own draws,
recomputed here from the key path:

- ``act``: ``_act_impl`` splits the key in 3, ``core.act`` splits ``act_key``
  in 3 (belief, efe, act); ``generate_beliefs`` splits the belief key in 2
  and draws the start from the first half; the refinement splits the act
  key in 2 and draws one normal per step from ``split(fp_key, steps)``.
- ``act_warm``: ``_act_warm_impl`` splits the key in 5 (feat, belief, act,
  noise, reset); the reset rows' fresh latents come from the reset key, the
  forward noise of the warm start from the belief key's first half.

Off the TPU the JAX core runs its float32 XLA scan whatever the config
says. For the bfloat16 and v2 configs the test makes it take its Pallas
path in interpret mode (``pallas_interpret``), as tests/test_pallas_denoise.py
runs the kernels, with deterministic beliefs only: interpret mode has no TPU
PRNG. float32 configs are held at ``MODEL_TOL`` (or rtol 1e-4 / atol 1e-5
on actions), bfloat16 ones at ``BF16_TOL``.
"""

import functools
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.configs.config import (
    BeliefDynamicsConfig,
    SemanticsConfig,
    TrainingConfig,
)
from active_inference_diffusion_tpu.ops import denoise as jax_denoise
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.core.active_inference import ActStart
from torch_parity import (
    ACT_DIM,
    BF16_TOL,
    CPU,
    MODEL_TOL,
    OBS_DIM,
    B,
    D,
    jax_agent,
    jax_core_and_params,
    normal,
    t,
    tiny_config,
    torch_agent,
    torch_core,
)

REPO = Path(__file__).resolve().parents[1]
SEED = torch.tensor(0, dtype=torch.int64)
ACT_TOL = dict(rtol=1e-4, atol=1e-5)
REFINE = BeliefDynamicsConfig(use_belief_dynamics=True, refine_steps=2)
# (compute_dtype, denoiser_kernel) -> tolerance; float32 v1 runs the JAX XLA scan
SWEEPS = {
    ("float32", "v1"): ACT_TOL,
    ("bfloat16", "v1"): BF16_TOL,
    ("bfloat16", "v2"): BF16_TOL,
}


def jax_normal(key, *shape):
    return np.asarray(jax.random.normal(key, shape, dtype=jnp.float32))


def jax_draws(key, batch, refine_steps=0, warm=False):
    """The draws of the JAX agent's ``act`` (or ``act_warm``) as the port's
    ``ActStart``, and the fresh reset latents of ``act_warm``."""
    fresh = None
    if warm:
        _, belief_key, act_key, _, reset_key = jax.random.split(key, 5)
        fresh = t(jax_normal(reset_key, batch, D))
    else:
        _, agent_act_key, _ = jax.random.split(key, 3)
        belief_key, _, act_key = jax.random.split(agent_act_key, 3)
    init_key, _ = jax.random.split(belief_key)
    refine_noise = None
    if refine_steps:
        fp_key, _ = jax.random.split(act_key)
        refine_noise = t(np.stack(
            [jax_normal(k, batch, D) for k in jax.random.split(fp_key, refine_steps)]
        ))
    return ActStart(t(jax_normal(init_key, batch, D)), SEED, refine_noise), fresh


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Put a JAX agent's core on its Pallas sweep in interpret mode: the gate
    is set as if on a TPU, and the two sweep functions, which
    ``generate_beliefs`` imports at call time, run in interpret mode."""
    for name in ("fused_denoise_sweep", "fused_denoise_sweep_v2"):
        monkeypatch.setattr(
            jax_denoise, name, functools.partial(getattr(jax_denoise, name), interpret=True)
        )

    def on(jagent):
        jagent.core._fused_sweep_checked = True
        return jagent

    return on


def slice_config(compute_dtype, denoiser_kernel, **overrides):
    return tiny_config(
        deterministic_beliefs=True, belief_dynamics=REFINE, compute_dtype=compute_dtype,
        denoiser_kernel=denoiser_kernel, **overrides,
    )


# policy_squash None resolves to tanh (corrected mode); False leaves the
# Gaussian mean unsquashed, so the clip to [-1, 1] is exercised too.
@pytest.mark.parametrize("policy_squash", [None, False], ids=["tanh", "unsquashed"])
def test_act_matches_jax_agent(policy_squash):
    cfg = tiny_config(deterministic_beliefs=True, policy_squash=policy_squash)
    _, params = jax_core_and_params(cfg)
    obs = 2.0 * normal(20, B, OBS_DIM)
    key = jax.random.PRNGKey(21)
    # act reads only state.params when no EMA acting flag is set
    expected = jax_agent(cfg).act(
        types.SimpleNamespace(params=params), obs, key, deterministic=True, collect=False
    )
    start, _ = jax_draws(key, B)
    got, _ = torch_agent(cfg, params).act_from_start(t(obs), start, None, deterministic=True)
    if policy_squash is False:
        assert (np.abs(expected) == 1.0).any()  # some actions were clipped
    np.testing.assert_allclose(got.numpy(), expected, **ACT_TOL)


@pytest.mark.parametrize("sweep", list(SWEEPS), ids=["-".join(s) for s in SWEEPS])
def test_act_with_refinement_matches_jax_agent(pallas_interpret, sweep):
    """The humanoid_state.yaml path at tiny widths: the sweep in the
    config's variant and weight type, then two Fokker-Planck refinement
    steps, then the policy."""
    cfg = slice_config(*sweep)
    _, params = jax_core_and_params(cfg)
    jagent = jax_agent(cfg)
    if sweep != ("float32", "v1"):
        pallas_interpret(jagent)
    obs = normal(40, B, OBS_DIM)
    key = jax.random.PRNGKey(41)
    expected = jagent.act(
        types.SimpleNamespace(params=params), obs, key, deterministic=True, collect=False
    )
    start, _ = jax_draws(key, B, REFINE.refine_steps)
    got, _ = torch_agent(cfg, params).act_from_start(t(obs), start, None, deterministic=True)
    np.testing.assert_allclose(got.numpy(), expected, **SWEEPS[sweep])


@pytest.mark.parametrize("sweep", [("float32", "v1"), ("bfloat16", "v1")],
                         ids=["float32-v1", "bfloat16-v1"])
def test_act_warm_matches_jax_agent(pallas_interpret, sweep):
    """Warm start over a truncated sweep of 3 of the 5 steps: rows 0 and 5
    reset to fresh latents, the others start from their previous belief
    forward-noised to t = 2. Returns the actions and the refined latents."""
    cfg = slice_config(*sweep)
    _, params = jax_core_and_params(cfg)
    jagent = jax_agent(cfg, TrainingConfig(collect_diffusion_steps=3))
    if sweep != ("float32", "v1"):
        pallas_interpret(jagent)
    obs, prev = normal(42, B, OBS_DIM), normal(43, B, D)
    reset = np.zeros(B, bool)
    reset[[0, 5]] = True
    key = jax.random.PRNGKey(44)
    actions, latents = jagent.act_warm(
        types.SimpleNamespace(params=params), obs, key, jnp.asarray(prev), reset,
        deterministic=True,
    )
    start, fresh = jax_draws(key, B, REFINE.refine_steps, warm=True)
    agent = torch_agent(cfg, params, TrainingConfig(collect_diffusion_steps=3))
    got, got_latents = agent.act_warm_from_start(
        t(obs), t(prev), torch.from_numpy(reset), fresh, start, None, deterministic=True,
        num_steps=3,
    )
    tol = SWEEPS[sweep]
    np.testing.assert_allclose(got.numpy(), actions, **tol)
    np.testing.assert_allclose(
        got_latents.numpy(), np.asarray(latents), **(MODEL_TOL if tol is ACT_TOL else tol)
    )


def test_beliefs_match_jax_generate_beliefs():
    cfg = tiny_config()
    jcore, params = jax_core_and_params(cfg)
    tcore = torch_core(cfg, params)
    obs = normal(22, B, OBS_DIM)
    key = jax.random.PRNGKey(23)
    z0 = jax_normal(jax.random.split(key)[0], B, D)
    generate = jax.jit(functools.partial(jcore.generate_beliefs, deterministic=True,
                                         compute_reconstruction=False))
    for batch in (B, 1):  # ddof=1 std; zeros at batch 1
        expected = generate(params, key, obs[:batch])
        got = tcore.beliefs_from_start(t(obs[:batch]), t(z0[:batch]), SEED, deterministic=True)
        for name in ("latent", "latent_mean", "latent_std"):
            np.testing.assert_allclose(
                getattr(got, name).numpy(), np.asarray(getattr(expected, name)),
                err_msg=name, **MODEL_TOL,
            )
        assert got.trajectory is None


def test_agent_act_on_cpu():
    cfg = tiny_config(belief_dynamics=REFINE, compute_dtype="bfloat16")
    _, params = jax_core_and_params(cfg)
    agent = torch_agent(cfg, params, TrainingConfig(collect_diffusion_steps=3))
    obs = normal(24, 6, OBS_DIM)
    actions = agent.act(obs, torch.Generator().manual_seed(0), deterministic=False, collect=True)
    assert actions.shape == (6, ACT_DIM) and actions.dtype == np.float32
    assert np.isfinite(actions).all() and (np.abs(actions) <= 1.0).all()
    # collect=True runs collect_diffusion_steps: replay the same draws
    g = torch.Generator().manual_seed(0)
    start = agent.core.draw_start(6, g)
    assert start.refine_noise.shape == (REFINE.refine_steps, 6, D)
    again, _ = agent.act_from_start(t(obs), start, g, deterministic=False, num_steps=3)
    np.testing.assert_array_equal(actions, again.numpy())
    # act_warm threads the latents; its draws are fresh latents, then the start
    prev = torch.zeros(6, D)
    reset = np.array([True, False] * 3)
    warm, latents = agent.act_warm(obs, torch.Generator().manual_seed(1), prev, reset)
    g = torch.Generator().manual_seed(1)
    fresh = torch.randn((6, D), generator=g)
    start = agent.core.draw_start(6, g)
    again, again_latents = agent.act_warm_from_start(
        t(obs), prev, torch.from_numpy(reset), fresh, start, g, num_steps=3
    )
    np.testing.assert_array_equal(warm, again.numpy())
    assert torch.equal(latents, again_latents) and latents.shape == (6, D)
    # one observation -> a batch of one
    single = agent.act(obs[0], torch.Generator().manual_seed(1), deterministic=True)
    assert single.shape == (1, ACT_DIM)


@pytest.mark.parametrize(
    "overrides,call",
    [
        (dict(plan_candidates=4), "act"),
        (dict(semantics=SemanticsConfig(mode="faithful")), "compute_efe_info"),
        (dict(pixel_observation=True), "construct"),
    ],
    ids=["act_planned", "efe_info", "pixels"],
)
def test_unported_branches_raise(overrides, call):
    cfg = tiny_config(**overrides)
    _, params = jax_core_and_params()  # the weights depend on the widths only
    obs = normal(25, 2, OBS_DIM)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        agent = torch_agent(cfg, params)
        if call == "act":
            agent.act(obs, g)
        elif call == "compute_efe_info":
            agent.core.act(g, t(obs), compute_efe_info=True)


def test_default_device_is_cuda():
    """Without a device the core and the agent run on CUDA, and raise where
    there is none: the CPU runs only when asked for."""
    cfg = tiny_config()
    _, params = jax_core_and_params(cfg)
    assert torch_agent(cfg, params).device == CPU  # asked for
    from torch_parity import port_config

    make = functools.partial(
        DiffusionStateAgent, OBS_DIM, ACT_DIM, port_config(cfg), port_config(TrainingConfig())
    )
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_port_imports_no_jax():
    """The humanoid_state.yaml agent cut to a tiny width (bfloat16 weights,
    Fokker-Planck refinement) calling ``act`` and ``act_warm``, then one
    ``train_step`` and a ``train_epoch`` of two updates over a device
    replay ring on the CPU; hopper_state_dreamer.yaml (loaded from its file,
    cut to a tiny width: posterior acting with the EMA policy, the imagined
    actor-critic over the ensemble) the same; then hopper_planar_fused.yaml
    at a tiny width on the planar engine: one ``collect_and_store`` and one
    ``fused_eval`` step; then one step of Ant3D-v0 on the 3D engine. None of
    it loads a module of jax, flax or the JAX package, mujoco or gymnasium. The widths are tiny: it checks imports, not numbers."""
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)  # beside the test workers; the widths are tiny\n"
        "from active_inference_diffusion_torch import DiffusionStateAgent\n"
        "from active_inference_diffusion_torch.configs.presets import (\n"
        "    HUMANOID_ACT_DIM, HUMANOID_OBS_DIM, humanoid_state)\n"
        "cfg, training = humanoid_state()\n"
        "cfg.latent_dim, cfg.hidden_dim, cfg.score_num_layers = 8, 64, 1\n"
        "cfg.diffusion.num_diffusion_steps = 5\n"
        "training.collect_diffusion_steps = 3\n"
        "agent = DiffusionStateAgent(HUMANOID_OBS_DIM, HUMANOID_ACT_DIM, cfg, training,\n"
        "                            device='cpu')\n"
        "obs = np.zeros((2, HUMANOID_OBS_DIM), np.float32)\n"
        "g = torch.Generator().manual_seed(0)\n"
        "a = agent.act(obs, g)\n"
        "w, z = agent.act_warm(obs, g, torch.zeros(2, cfg.latent_dim), np.array([True, False]))\n"
        "assert a.shape == w.shape == (2, HUMANOID_ACT_DIM) and np.isfinite(a).all()\n"
        "assert np.isfinite(w).all() and z.shape == (2, cfg.latent_dim)\n"
        "state = agent.new_train_state(0)\n"
        "rng = np.random.default_rng(0)\n"
        "batch = {k: torch.tensor(rng.standard_normal(s), dtype=torch.float32) for k, s in (\n"
        "    ('observations', (2, HUMANOID_OBS_DIM)), ('next_observations', (2, HUMANOID_OBS_DIM)),\n"
        "    ('actions', (2, HUMANOID_ACT_DIM)), ('rewards', (2,)), ('dones', (2,)))}\n"
        "state, metrics = agent.train_step(state, batch)\n"
        "assert state.step == 1 and all(bool(torch.isfinite(v)) for v in metrics.values())\n"
        "from active_inference_diffusion_torch.data.replay import DeviceReplayBuffer, replay_init\n"
        "cfg.batch_size = 4\n"
        "ring = DeviceReplayBuffer(8, (HUMANOID_OBS_DIM,), HUMANOID_ACT_DIM, device='cpu')\n"
        "ring.add_batch(*(rng.standard_normal(s) for s in ((5, HUMANOID_OBS_DIM),\n"
        "    (5, HUMANOID_ACT_DIM), (5,), (5, HUMANOID_OBS_DIM))), rng.random(5) < 0.2)\n"
        "state, metrics = agent.train_epoch(state, ring.state, 2)\n"
        "assert state.step == 3 and agent.total_steps == 2\n"
        "assert all(bool(torch.isfinite(v)) for v in metrics.values())\n"
        "from active_inference_diffusion_torch import load_yaml_config\n"
        "def tiny(name):\n"
        "    cfg, training, _ = load_yaml_config(f'examples/configs/{name}.yaml')\n"
        "    cfg.latent_dim, cfg.hidden_dim, cfg.score_num_layers, cfg.batch_size = 8, 32, 1, 4\n"
        "    return cfg, training\n"
        "cfg, training = tiny('hopper_state_dreamer')\n"
        "agent = DiffusionStateAgent(HUMANOID_OBS_DIM, HUMANOID_ACT_DIM, cfg, training,\n"
        "                            device='cpu')\n"
        "state = agent.new_train_state(0)\n"
        "a = agent.act(obs, g, state=state)\n"
        "assert a.shape == (2, HUMANOID_ACT_DIM) and np.isfinite(a).all()\n"
        "state, metrics = agent.train_step(state, batch)\n"
        "state, metrics = agent.train_epoch(state, ring.state, 2)\n"
        "assert state.step == 3 and all(bool(torch.isfinite(v)) for v in metrics.values())\n"
        "from active_inference_diffusion_torch import train_fused\n"
        "from active_inference_diffusion_torch.envs import device_envs as de\n"
        "from active_inference_diffusion_torch.envs.collect_graph import CollectGraph, EvalGraph\n"
        "env = de.make_device_env('HopperPlanar-v0', device='cpu')\n"
        "cfg, training = tiny('hopper_planar_fused')\n"
        "agent = DiffusionStateAgent(env.observation_dim, env.action_dim, cfg, training,\n"
        "                            device='cpu')\n"
        "state = agent.new_train_state(0)\n"
        "policy = de.ExplorationNoise(de.make_rollout_policy(agent.core, env,\n"
        "    act_from_posterior=True), env, torch.zeros(()))\n"
        "ring = replay_init(8, (env.observation_dim,), env.action_dim, device='cpu')\n"
        "states = env.reset(env.draw_reset(2, g))\n"
        "states, _, mean = train_fused.collect_and_store(agent, state, CollectGraph(env, policy,\n"
        "    2, 1), ring, states, None, g, 0.1)\n"
        "assert ring.host_size == 2 and bool(torch.isfinite(mean))\n"
        "evaluator = EvalGraph(env, de.make_rollout_policy(agent.core, env, deterministic=True,\n"
        "    act_from_posterior=True), 2, 1)\n"
        "assert bool(torch.isfinite(train_fused.eval_return(agent, state, evaluator, g)))\n"
        "env = de.make_device_env('Ant3D-v0', device='cpu')\n"
        "s = env.step(env.reset(env.draw_reset(2, g)), torch.zeros(2, env.action_dim))\n"
        "assert s.obs.shape == (2, 27) and bool(torch.isfinite(s.obs).all())\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                ('jax', 'flax', 'active_inference_diffusion_tpu', 'mujoco', 'gymnasium'))\n"
        "assert not loaded, loaded\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
