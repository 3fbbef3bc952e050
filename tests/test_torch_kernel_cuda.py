"""The CUDA denoise-sweep kernels against their plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU, is marked ``cuda`` and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) Tolerances:
with float32 weights the kernel and the plain version differ in summation
order and in 3xTF32's dropped lo x lo term (2^-22 of a product): rtol 1e-4 /
atol 1e-5 at every width, which the kernels built with one TF32 product
(hi x hi) fail in every float32 case (PERF.md). With bfloat16 weights a
one-ulp float32 difference (the tensor cores sum in another order) can flip
a bfloat16 rounding of an activation, and the flip carries through the
later steps: rtol 1e-2 / atol 5e-3. The kernels pad a hidden width to a
multiple of 64; most small shapes use hidden 64, and the padded and the
streamed plans have tests of their own. The last tests hold ``train_epoch``
on the card, each update a replayed CUDA graph, against the eager loop of
the same updates (the flagship's flags, and hopper_state_dreamer.yaml's
across the policy anchor's gate), a capture that fails, and acting with
the score network's EMA. The fused collect's tests hold the collect and
eval graphs (one captured env step, replayed) against the eager steps on
the same draws: Pendulum with the sweep and with warm starts (one sweep
launch per env step), the exploration scale written between collects,
HopperPlanar's physics, a step that cannot be captured, Ant3D's collect
with the sweep, and a Humanoid3D step that runs with no host sync and
replays equal to its eager run. The grounded-belief update in a graph
against the eager loop (its differentiated sweep the plain one, counted in
``PLAIN_RUNS``), the policy's decaying rate inside a graph, and a checkpoint
round trip on the card with its next update.
"""

import numpy as np
import pytest
import torch

from active_inference_diffusion_torch import (
    ActiveInferenceConfig,
    DiffusionConfig,
    DiffusionStateAgent,
    TrainingConfig,
)
from active_inference_diffusion_torch.configs.config import BeliefDynamicsConfig
from active_inference_diffusion_torch.core.schedules import make_schedule
from active_inference_diffusion_torch.data.replay import DeviceReplayBuffer, replay_sample
from active_inference_diffusion_torch.models.score_network import LatentScoreNetwork
from active_inference_diffusion_torch.ops.denoise import (
    LAUNCHES,
    PLAIN_RUNS,
    denoise_sweep_reference,
    fused_denoise_sweep,
    fused_denoise_sweep_v2,
    kernel_name,
    kernel_plan,
    packed_trunk_weights,
)

pytestmark = pytest.mark.cuda

OBS_DIM = 5
WRAPPERS = {"v1": fused_denoise_sweep, "v2": fused_denoise_sweep_v2}
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5), torch.bfloat16: dict(rtol=1e-2, atol=5e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p.shape[-1] if p.dim() >= 2 else p.numel()
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in**0.5)


def sweep_args(device, batch, latent, hidden, layers, steps, seed=0, variant="v1",
               dtype=torch.float32):
    net = LatentScoreNetwork(latent, OBS_DIM, hidden_dim=hidden, num_layers=layers).to(device)
    randomize(net, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    z0 = torch.randn((batch, latent), generator=gen, device=device)
    obs = torch.randn((batch, OBS_DIM), generator=gen, device=device)
    with torch.no_grad():
        obs_emb = net.obs_embedding(obs).contiguous()
        t = torch.arange(steps - 1, -1, -1, device=device, dtype=torch.float32)
        t_embs = net.time_embedding(t, continuous=False).contiguous()
    seed_t = torch.tensor(99, dtype=torch.int64, device=device)
    return (make_schedule(steps, device=device), packed_trunk_weights(net, variant, dtype), z0,
            obs_emb, t_embs, seed_t, steps, layers)


# (batch, latent, hidden, layers): the parity tests' widths, a ragged batch,
# and a latent that is not a multiple of 4 (padded rows, matmul tail).
@pytest.mark.parametrize("shape", [(8, 8, 64, 2), (37, 8, 64, 2), (20, 50, 64, 1)])
@pytest.mark.parametrize("deterministic", [True, False])
def test_kernel_matches_plain_version(cuda, shape, deterministic):
    args = sweep_args(cuda, *shape, steps=5)
    before = LAUNCHES["denoise_sweep_v1_f32"]
    got = fused_denoise_sweep(*args, deterministic=deterministic)
    torch.cuda.synchronize()
    assert LAUNCHES["denoise_sweep_v1_f32"] == before + 1
    want = denoise_sweep_reference(*args, deterministic=deterministic)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize(
    "variant,dtype",
    [("v1", torch.bfloat16), ("v2", torch.float32), ("v2", torch.bfloat16)],
    ids=["v1-bf16", "v2-f32", "v2-bf16"],
)
@pytest.mark.parametrize("shape", [(8, 8, 32, 2), (37, 50, 64, 2)], ids=["tiny", "ragged"])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sto"])
def test_kernel_variants_match_plain_version(cuda, variant, dtype, shape, deterministic):
    shape = shape[:2] + (max(shape[2], 64),) + shape[3:]  # the kernels' hidden: a multiple of 64
    args = sweep_args(cuda, *shape, steps=5, variant=variant, dtype=dtype)
    name = kernel_name(variant, dtype)
    before = dict(LAUNCHES)
    got = WRAPPERS[variant](*args, deterministic=deterministic)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, name: before[name] + 1}
    want = denoise_sweep_reference(*args, deterministic=deterministic)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL[dtype])


def test_v2_kernel_matches_v1_kernel(cuda):
    """float32 v1 and v2 kernels draw the same noise: the stochastic sweeps
    agree up to the reassociation of Wv @ Wo."""
    v1 = fused_denoise_sweep(*sweep_args(cuda, 37, 8, 64, 2, steps=5), deterministic=False)
    v2 = fused_denoise_sweep_v2(
        *sweep_args(cuda, 37, 8, 64, 2, steps=5, variant="v2"), deterministic=False
    )
    np.testing.assert_allclose(v2.cpu().numpy(), v1.cpu().numpy(), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kernel", ["v1", "v2"])
def test_agent_act_launches_the_kernel_once_per_call(cuda, kernel):
    cfg = ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=2, latent_dim=8, hidden_dim=64,
        score_num_layers=2, diffusion=DiffusionConfig(num_diffusion_steps=5),
        belief_dynamics=BeliefDynamicsConfig(use_belief_dynamics=True),
    )
    cfg.tpu.compute_dtype, cfg.tpu.denoiser_kernel = "bfloat16", kernel
    agent = DiffusionStateAgent(OBS_DIM, 2, cfg, TrainingConfig())
    assert agent.device.type == "cuda"  # the default
    randomize(agent.core, 1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    obs = np.random.default_rng(0).standard_normal((6, OBS_DIM)).astype(np.float32)
    name = kernel_name(kernel, torch.bfloat16)
    before = dict(LAUNCHES)
    for deterministic in (True, False, False):
        actions = agent.act(obs, gen, deterministic=deterministic)
        assert actions.shape == (6, 2) and np.isfinite(actions).all()
        assert np.abs(actions).max() <= 1.0
    actions, latents = agent.act_warm(obs, gen, torch.zeros(6, 8, device=cuda),
                                      np.array([True, False] * 3))
    assert np.isfinite(actions).all() and latents.shape == (6, 8)
    assert LAUNCHES == {**before, name: before[name] + 4}


def test_kernel_raises_beyond_its_shared_memory_plan(cuda):
    """Beyond the 48 MiB of trunk weights the kernels take (float32, latent
    128, hidden 384, 6 blocks: 51.1 MB) the pack has no kernel layout and the
    wrappers raise; they never run the plain sweep in its place."""
    for variant in ("v1", "v2"):
        args = list(sweep_args(cuda, 4, 128, 384, 6, steps=2, variant=variant))
        before = dict(LAUNCHES)
        with pytest.raises(ValueError, match="no kernel layout"):
            WRAPPERS[variant](*args, deterministic=True)
        assert LAUNCHES == before


def test_kernel_rejects_what_it_does_not_take(cuda):
    args = list(sweep_args(cuda, 8, 8, 64, 2, steps=5))
    strided = list(args)
    strided[2] = torch.randn(8, 16, device=cuda)[:, ::2]  # non-contiguous z0
    with pytest.raises(ValueError, match="contiguous"):
        fused_denoise_sweep(*strided, deterministic=True)
    cpu_seed = list(args)
    cpu_seed[5] = torch.tensor(0, dtype=torch.int64)
    with pytest.raises(TypeError, match="seed"):
        fused_denoise_sweep(*cpu_seed, deterministic=True)
    with pytest.raises(ValueError, match="packed for v1"):
        fused_denoise_sweep_v2(*args, deterministic=True)


# The humanoid_state.yaml width (latent 64, hidden 256, 6 blocks) at a few
# steps: one cluster (B=1, 8), a ragged cluster (37), one wave of 16
# clusters on 132 SMs (256) and two waves (512).
@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("batch", [1, 8, 37, 256, 512])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sto"])
def test_bf16_kernels_at_the_humanoid_width(cuda, variant, batch, deterministic):
    """5 steps on the preset's 50-step cosine schedule, output_multiplier 1, as
    chip_smoke.py drives this width."""
    args = list(sweep_args(cuda, batch, 64, 256, 6, steps=5, seed=batch, variant=variant,
                           dtype=torch.bfloat16))
    args[0] = make_schedule(50, "cosine", device=cuda)
    args[1] = args[1]._replace(output_multiplier=torch.ones((), device=cuda))
    name = kernel_name(variant, torch.bfloat16)
    before = dict(LAUNCHES)
    got = WRAPPERS[variant](*args, deterministic=deterministic)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, name: before[name] + 1}
    want = denoise_sweep_reference(*args, deterministic=deterministic)
    # chip_smoke.py's bf16 sweep tolerance for this width: a flipped bf16 rounding
    # moves a value by its own 2**-8 relative step, over 6 blocks of width 256.
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-2, atol=3e-2)


def test_v2_bf16_kernel_matches_v1_bf16_kernel(cuda):
    """The same seed draws the same noise in both bf16 kernels; they round at
    different sites (v1 rounds v_proj's output, v2 the composed Wv @ Wo), so
    they agree to the JAX package's bf16-vs-f32 tolerance."""
    v1 = fused_denoise_sweep(
        *sweep_args(cuda, 37, 50, 64, 2, steps=5, dtype=torch.bfloat16), deterministic=False
    )
    v2 = fused_denoise_sweep_v2(
        *sweep_args(cuda, 37, 50, 64, 2, steps=5, variant="v2", dtype=torch.bfloat16),
        deterministic=False,
    )
    np.testing.assert_allclose(v2.cpu().numpy(), v1.cpu().numpy(), rtol=0.1, atol=0.05)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_bf16_pack_rebuilt_after_an_in_place_update(cuda, variant):
    """An in-place update of the weights rebuilds the pack and its kernel
    layout; the kernel then computes with the new weights."""
    net = LatentScoreNetwork(8, OBS_DIM, hidden_dim=64, num_layers=2).to(cuda)
    randomize(net, 3)
    args = list(sweep_args(cuda, 8, 8, 64, 2, steps=5, variant=variant, dtype=torch.bfloat16))
    args[1] = packed = packed_trunk_weights(net, variant, torch.bfloat16)
    before = WRAPPERS[variant](*args, deterministic=True)
    with torch.no_grad():
        net.blocks[0].mlp_fc1.weight.mul_(-1.0)
    args[1] = repacked = packed_trunk_weights(net, variant, torch.bfloat16)
    assert repacked is not packed and not torch.equal(repacked.kernel.weights, packed.kernel.weights)
    after = WRAPPERS[variant](*args, deterministic=True)
    want = denoise_sweep_reference(*args, deterministic=True)
    np.testing.assert_allclose(after.cpu().numpy(), want.cpu().numpy(), **TOL[torch.bfloat16])
    assert not torch.allclose(after, before)


def test_bf16_kernels_raise_on_an_unsupported_width(cuda):
    """bfloat16 beyond the 48 MiB of trunk weights (hidden 512, 8 blocks:
    60 MB) raises."""
    for variant in ("v1", "v2"):
        args = sweep_args(cuda, 8, 8, 512, 8, steps=2, variant=variant, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="no kernel layout"):
            WRAPPERS[variant](*args, deterministic=True)


def _wide_sweep(cuda, variant, batch, latent, hidden, schedule_len, steps, deterministic):
    """A float32 sweep at a preset's width (6 blocks), output_multiplier 1, as
    chip_smoke.py drives it: one launch, held against the plain version."""
    args = list(sweep_args(cuda, batch, latent, hidden, 6, steps=steps, seed=batch,
                           variant=variant))
    args[0] = make_schedule(schedule_len, "cosine", device=cuda)
    args[1] = args[1]._replace(output_multiplier=torch.ones((), device=cuda))
    name = kernel_name(variant, torch.float32)
    before = dict(LAUNCHES)
    got = WRAPPERS[variant](*args, deterministic=deterministic)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, name: before[name] + 1}
    want = denoise_sweep_reference(*args, deterministic=deterministic)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL[torch.float32])


# The humanoid_state.yaml width at a few steps of its 50-step schedule: one
# cluster (B=1, 8), a ragged cluster (37), 16 clusters (256) and two waves (512).
@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("batch", [1, 8, 37, 256, 512])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sto"])
def test_f32_kernels_at_the_humanoid_width(cuda, variant, batch, deterministic):
    _wide_sweep(cuda, variant, batch, 64, 256, 50, 5, deterministic)


# The flagship width (latent 32, hidden 128), the full 25-step sweep, at the
# serving batch, the batched one and the train step's belief sweep (2 x 256
# rows: 32 tiles, three waves of the 15 clusters the card holds).
@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("batch", [1, 256, 512])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sto"])
def test_f32_kernels_at_the_flagship_width(cuda, variant, batch, deterministic):
    _wide_sweep(cuda, variant, batch, 32, 128, 25, 25, deterministic)


def test_f32_kernels_raise_on_an_unsupported_width(cuda):
    """float32 beyond the 48 MiB of trunk weights (hidden 384, 6 blocks)
    raises, whatever the batch."""
    for variant in ("v1", "v2"):
        for batch in (1, 37):
            args = sweep_args(cuda, batch, 8, 384, 6, steps=2, variant=variant)
            with pytest.raises(ValueError, match="no kernel layout"):
                WRAPPERS[variant](*args, deterministic=True)


# Hidden widths the kernels pad to a multiple of 64 (32 to 64, 96 to 128): zero
# weights on the padded columns, adaLN statistics over the real ones.
@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(8, 8, 32, 2), (37, 50, 96, 2)], ids=["h32", "h96"])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sto"])
def test_kernels_at_a_padded_hidden_width(cuda, variant, dtype, shape, deterministic):
    args = sweep_args(cuda, *shape, steps=5, variant=variant, dtype=dtype)
    assert not kernel_plan(args[1]).streamed
    name = kernel_name(variant, dtype)
    before = dict(LAUNCHES)
    got = WRAPPERS[variant](*args, deterministic=deterministic)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, name: before[name] + 1}
    want = denoise_sweep_reference(*args, deterministic=deterministic)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL[dtype])


# Widths whose operand copies do not fit a CTA's shared memory, streamed from
# global memory: the config's default (latent 128, hidden 512) in bfloat16 at 6
# blocks and in float32 at 2, and float32 at hidden 320 (padded from 300).
STREAMED = {"default-bf16": (128, 512, 6, torch.bfloat16),
            "default-f32-l2": (128, 512, 2, torch.float32),
            "h300-f32": (32, 300, 6, torch.float32)}
@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("width", sorted(STREAMED))
@pytest.mark.parametrize("batch", [8, 37])
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sto"])
def test_kernels_in_the_streamed_plan(cuda, variant, width, batch, deterministic):
    latent, hidden, layers, dtype = STREAMED[width]
    args = list(sweep_args(cuda, batch, latent, hidden, layers, steps=5, seed=batch,
                           variant=variant, dtype=dtype))
    args[0] = make_schedule(100, "cosine", device=cuda)
    args[1] = args[1]._replace(output_multiplier=torch.ones((), device=cuda))
    assert kernel_plan(args[1]).streamed
    name = kernel_name(variant, dtype)
    before = dict(LAUNCHES)
    got = WRAPPERS[variant](*args, deterministic=deterministic)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, name: before[name] + 1}
    want = denoise_sweep_reference(*args, deterministic=deterministic)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **PLAIN_TOL[dtype])


def _c1_agent(cuda, hidden, dtype, layers):
    cfg = ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=2, latent_dim=128, hidden_dim=hidden,
        score_num_layers=layers, diffusion=DiffusionConfig(num_diffusion_steps=5),
        deterministic_beliefs=True,
    )
    cfg.tpu.compute_dtype = dtype
    agent = DiffusionStateAgent(OBS_DIM, 2, cfg, TrainingConfig())
    randomize(agent.core, 2)
    twin = DiffusionStateAgent(OBS_DIM, 2, cfg, TrainingConfig(), device="cpu")
    twin.core.load_state_dict(agent.core.state_dict())
    return agent, twin


def _c1_act_and_beliefs(cuda, agent, twin, counts):
    """``act`` and ``generate_beliefs`` on the card, with the counters'
    increments (``counts``: LAUNCHES, PLAIN_RUNS) checked, held against the
    CPU twin from the same start draws."""
    obs = np.random.default_rng(1).standard_normal((8, OBS_DIM)).astype(np.float32)
    gen = torch.Generator(device=cuda).manual_seed(0)
    launches, plain = dict(LAUNCHES), dict(PLAIN_RUNS)
    state = gen.get_state()
    actions = agent.act(obs, gen, deterministic=True, collect=False)
    belief = agent.core.generate_beliefs(gen, torch.from_numpy(obs).to(cuda), deterministic=True)
    torch.cuda.synchronize()
    assert ({k: LAUNCHES[k] - launches[k] for k in LAUNCHES},
            {k: PLAIN_RUNS[k] - plain[k] for k in PLAIN_RUNS}) == counts
    gen.set_state(state)
    start = agent.core.draw_start(8, gen)
    want, _ = twin.act_from_start(torch.from_numpy(obs), start.to("cpu"), None, deterministic=True)
    tol = PLAIN_TOL[agent.core.sweep_dtype]
    np.testing.assert_allclose(actions, want.numpy(), **tol)
    start = agent.core.draw_start(8, gen)
    want = twin.core.beliefs_from_start(torch.from_numpy(obs), start.noise.cpu(),
                                        start.seed.cpu(), deterministic=True)
    np.testing.assert_allclose(belief.latent.cpu().numpy(), want.latent.numpy(), **tol)
    np.testing.assert_allclose(float(belief.reconstruction_error),
                               float(want.reconstruction_error), **tol)


# Widths beyond the kernels' 48 MiB of trunk weights at 6 blocks (C1): the
# config's default (latent 128, hidden 512) and hidden 384, in float32. The card
# runs the plain sweep: no kernel launch, one plain run per sweep, the CPU
# twin's result. float32 at ``TOL``; bfloat16 (the kernel rows below) at
# chip_smoke's sweep tolerance, rtol 3e-2 / atol 3e-2: at hidden 512 each step
# has 4x the products of hidden 128, so more activations land on the other side
# of a bfloat16 rounding boundary between two orders of summation.
PLAIN_TOL = {torch.float32: TOL[torch.float32], torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
@pytest.mark.parametrize("hidden,dtype", [(512, "float32"), (384, "float32")],
                         ids=["default-f32", "h384-f32"])
def test_plain_path_on_the_card_where_no_kernel_takes_the_width(cuda, hidden, dtype):
    agent, twin = _c1_agent(cuda, hidden, dtype, 6)
    assert agent.core.sweep_uses_kernel is False
    name = kernel_name("v1", agent.core.sweep_dtype)
    zero = {k: 0 for k in LAUNCHES}
    _c1_act_and_beliefs(cuda, agent, twin, (zero, {**zero, name: 2}))


# The widths C1 found refused that the JAX core's fused sweep takes, at 6
# blocks: the config's default in bfloat16 (streamed) and hidden 96 in float32
# (padded to 128): one launch per sweep, no plain run.
@pytest.mark.parametrize("hidden,dtype", [(512, "bfloat16"), (96, "float32")],
                         ids=["default-bf16", "h96-f32"])
def test_kernel_path_at_the_c1_widths_the_gate_takes(cuda, hidden, dtype):
    agent, twin = _c1_agent(cuda, hidden, dtype, 6)
    assert agent.core.sweep_uses_kernel is True
    name = kernel_name("v1", agent.core.sweep_dtype)
    zero = {k: 0 for k in LAUNCHES}
    _c1_act_and_beliefs(cuda, agent, twin, ({**zero, name: 2}, zero))


@pytest.mark.parametrize("kernel", ["v1", "v2"])
def test_train_step_launches_the_sweep_once(cuda, kernel):
    """One belief sweep of 2B rows per train update, on the kernel of the
    config's variant; the update's losses are finite and every partition
    moves."""
    cfg = ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=2, latent_dim=8, hidden_dim=64,
        score_num_layers=2, diffusion=DiffusionConfig(num_diffusion_steps=5),
    )
    cfg.tpu.denoiser_kernel = kernel
    agent = DiffusionStateAgent(OBS_DIM, 2, cfg, TrainingConfig())
    state = agent.init_train_state(0)
    rng = np.random.default_rng(2)
    batch = {
        "observations": rng.standard_normal((16, OBS_DIM)),
        "next_observations": rng.standard_normal((16, OBS_DIM)),
        "actions": np.tanh(rng.standard_normal((16, 2))),
        "rewards": rng.standard_normal(16),
        "dones": (rng.random(16) < 0.2).astype(np.float32),
    }
    batch = {k: torch.tensor(v, dtype=torch.float32, device=cuda) for k, v in batch.items()}
    before = [p.detach().clone() for p in agent.core.parameters()]
    name = kernel_name(kernel, torch.float32)
    launches = dict(LAUNCHES)
    for step in range(2):
        state, metrics = agent.train_step(state, batch)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        assert (float(metrics["epistemic_mi"]) != 0.0) == (step == 0)
    assert LAUNCHES == {**launches, name: launches[name] + 2}
    for part, opt in state.optimizers.items():
        moved = [not torch.equal(p, b) for p, b in zip(agent.core.parameters(), before)
                 if any(p is q for q in opt.params)]
        assert any(moved), part


def test_kernel_follows_output_multiplier_in_place(cuda):
    """R1: the pack views the score network's ``output_multiplier`` on the
    card, and the kernel reads it when it runs: an in-place change after the
    pack is built moves the kernel's output without a repack."""
    args = sweep_args(cuda, 8, 8, 64, 2, steps=5)
    mult = args[1].output_multiplier
    assert mult.is_cuda and mult.dim() == 0
    first = fused_denoise_sweep(*args, deterministic=True)
    with torch.no_grad():
        mult.fill_(2.5)
    again = fused_denoise_sweep(*args, deterministic=True)
    torch.cuda.synchronize()
    assert not torch.allclose(first, again, **TOL[torch.float32])
    want = denoise_sweep_reference(*args, deterministic=True)
    np.testing.assert_allclose(again.cpu().numpy(), want.cpu().numpy(), **TOL[torch.float32])


def _epoch_pair(cuda, latent=8, hidden=64, layers=2, steps=5, batch=16, chunk=256, **flags):
    """Two agents with the same weights and fresh train states, and one
    seeded ring of 200 transitions on the card; ``flags`` set on the
    config."""
    cfg = ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=2, latent_dim=latent, hidden_dim=hidden,
        score_num_layers=layers, batch_size=batch,
        diffusion=DiffusionConfig(num_diffusion_steps=steps), **flags,
    )
    agents = [DiffusionStateAgent(OBS_DIM, 2, cfg, TrainingConfig(epoch_chunk_updates=chunk))
              for _ in range(2)]
    states = [agent.init_train_state(0) for agent in agents]
    ring = DeviceReplayBuffer(256, (OBS_DIM,), 2)
    rng = np.random.default_rng(4)
    ring.add_batch(rng.standard_normal((200, OBS_DIM)), np.tanh(rng.standard_normal((200, 2))),
                   rng.standard_normal(200), rng.standard_normal((200, OBS_DIM)),
                   rng.random(200) < 0.1)
    return agents, states, ring.state


def _eager_updates(agent, state, ring, updates):
    """The eager loop of ``train_step_from_draws``, drawn as ``train_epoch``
    draws; returns the state and each update's metrics."""
    out = []
    for _ in range(updates):
        indices, draws = agent.draw_update(state, ring, agent.config.batch_size)
        state, metrics = agent.train_step_from_draws(state, replay_sample(ring, indices), draws)
        out.append(metrics)
    return state, out


def _assert_same_training(graph_agent, graph_state, eager_agent, eager_state):
    for got, want in zip(graph_agent.core.parameters(), eager_agent.core.parameters()):
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    for got, want in ((graph_state.time_importance, eager_state.time_importance),
                      (graph_state.epistemic_running_mean, eager_state.epistemic_running_mean),
                      (graph_state.reward_norm.mean, eager_state.reward_norm.mean),
                      (graph_state.reward_norm.var, eager_state.reward_norm.var)):
        torch.testing.assert_close(got, want, **TOL[torch.float32])
    assert graph_state.step == eager_state.step
    assert all(graph_state.optimizers[k].count == o.count for k, o in eager_state.optimizers.items())


def test_graph_epoch_matches_the_eager_loop_across_a_mine_step(cuda):
    """Six updates from step 0 (MINE at steps 0 and 5) as graph replays,
    one ``train_epoch`` call each, against the eager loop with the same
    draws: every update's metrics, then the parameters and the state's
    fields. One sweep launch counted per replayed update, and one per
    capture's warm-up."""
    (graph, eager), (gstate, estate), ring = _epoch_pair(cuda)
    name = kernel_name("v1", torch.float32)
    before = dict(LAUNCHES)
    got = []
    for _ in range(6):
        gstate, metrics = graph.train_epoch(gstate, ring, 1)
        got.append(metrics)
    captures = graph._epoch_graphs.captures
    assert captures == 2
    assert LAUNCHES == {**before, name: before[name] + 6 + captures}
    estate, want = _eager_updates(eager, estate, ring, 6)
    for step, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        assert (float(g["epistemic_mi"]) != 0.0) == (step in (0, 5))
        for k in w:
            torch.testing.assert_close(g[k], w[k], **TOL[torch.float32], msg=f"{step} {k}")
    _assert_same_training(graph, gstate, eager, estate)
    assert graph.total_steps == 6


def test_act_after_a_graph_epoch_equals_the_eager_twin(cuda):
    """R2: ``act`` after graph epochs uses the weights the replays wrote,
    not a pack cached before them: epoch, act, epoch, act, against the same
    updates run eagerly."""
    (graph, eager), (gstate, estate), ring = _epoch_pair(cuda)
    obs = np.random.default_rng(6).standard_normal((8, OBS_DIM)).astype(np.float32)
    for _ in range(2):
        gstate, _ = graph.train_epoch(gstate, ring, 3)
        estate, _ = _eager_updates(eager, estate, ring, 3)
        acts = [agent.act(obs, torch.Generator(device=cuda).manual_seed(1), deterministic=True)
                for agent in (graph, eager)]
        np.testing.assert_allclose(acts[0], acts[1], **TOL[torch.float32])
    _assert_same_training(graph, gstate, eager, estate)


def test_graph_epoch_where_the_card_runs_the_plain_sweep(cuda):
    """float32 at latent 128 / hidden 384, 6 blocks, K=25, batch 32: beyond
    the kernels' 48 MiB, the plain sweep runs inside the captured update,
    counted once per replay; chunks of 2 and 1; the same training as the
    eager loop."""
    (graph, eager), (gstate, estate), ring = _epoch_pair(cuda, 128, 384, 6, 25, 32, chunk=2)
    assert graph.core.sweep_uses_kernel is False
    name = kernel_name("v1", torch.float32)
    launches, plain = dict(LAUNCHES), dict(PLAIN_RUNS)
    gstate, metrics = graph.train_epoch(gstate, ring, 3)
    assert LAUNCHES == launches
    assert PLAIN_RUNS == {**plain, name: plain[name] + 3 + graph._epoch_graphs.captures}
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    estate, _ = _eager_updates(eager, estate, ring, 3)
    _assert_same_training(graph, gstate, eager, estate)


def test_ground_graph_epoch_matches_the_eager_loop(cuda):
    """``ground_beliefs``: six updates as graph replays against the eager
    loop on the same draws (each step's sweep noise among them). The
    differentiated sweep is the plain one, counted in ``PLAIN_RUNS`` once
    per update, replay and capture's warm-up; the kernel never launches in
    training; acting afterwards launches it once."""
    (graph, eager), (gstate, estate), ring = _epoch_pair(cuda, ground_beliefs=True)
    name = kernel_name("v1", torch.float32)
    launches, plain = dict(LAUNCHES), dict(PLAIN_RUNS)
    got = []
    for _ in range(6):
        gstate, metrics = graph.train_epoch(gstate, ring, 1)
        got.append(metrics)
    estate, want = _eager_updates(eager, estate, ring, 6)
    assert LAUNCHES == launches
    assert PLAIN_RUNS == {**plain, name: plain[name] + 12 + graph._epoch_graphs.captures}
    for step, (g, w) in enumerate(zip(got, want)):
        for k in w:
            torch.testing.assert_close(g[k], w[k], **TOL[torch.float32], msg=f"{step} {k}")
    _assert_same_training(graph, gstate, eager, estate)
    graph.act(np.zeros((4, OBS_DIM), np.float32), torch.Generator(device=cuda).manual_seed(0))
    assert LAUNCHES == {**launches, name: launches[name] + 1}


def test_policy_rate_decays_inside_the_graph(cuda):
    """``policy_lr_decay_steps`` 3: five updates as graph replays and as the
    eager loop; after each, the policy's rate (a device tensor the update
    writes from AdamW's device-side count) is the same in both and equals
    the cosine schedule of that update's count; the same training."""
    from active_inference_diffusion_torch.agents.base import CosineDecay

    (graph, eager), (gstate, estate), ring = _epoch_pair(
        cuda, policy_lr_decay_steps=3, policy_lr_final_scale=0.1)
    schedule = CosineDecay(graph.config.learning_rate, 3, 0.1)
    for step in range(5):
        gstate, _ = graph.train_epoch(gstate, ring, 1)
        estate, _ = _eager_updates(eager, estate, ring, 1)
        rates = [float(s.optimizers["policy"].lr) for s in (gstate, estate)]
        assert rates[0] == rates[1]
        np.testing.assert_allclose(rates[0], float(schedule(torch.tensor(step))), rtol=1e-6)
    _assert_same_training(graph, gstate, eager, estate)


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """Three graph updates, a checkpoint with the ring, a load into a fresh
    agent and ring on the card: every tensor equal, and the next update of
    both equal."""
    from active_inference_diffusion_torch.utils import checkpoints

    (first, other), (state, template), ring = _epoch_pair(cuda, ground_beliefs=True)
    state, _ = first.train_epoch(state, ring, 3)
    checkpoints.save_checkpoint(str(tmp_path), first, state, step=3, name="final",
                                replay_state=ring)
    fresh = DeviceReplayBuffer(256, (OBS_DIM,), 2).state
    restored, meta = checkpoints.load_checkpoint(str(tmp_path / "final"), other, template,
                                                 replay_template=fresh)
    assert meta["replay_state"] is fresh and meta["total_steps"] == 3

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, list):
            return all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    assert same(checkpoints.train_state_dict(first, state),
                checkpoints.train_state_dict(other, restored))
    assert same(checkpoints.replay_state_dict(ring), checkpoints.replay_state_dict(fresh))
    state, _ = first.train_epoch(state, ring, 1)
    restored, _ = other.train_epoch(restored, fresh, 1)
    assert same(checkpoints.train_state_dict(first, state),
                checkpoints.train_state_dict(other, restored))


def test_a_capture_that_fails_raises(cuda, monkeypatch):
    """A host read inside the captured update (an injected ``.item()``)
    makes ``train_epoch`` raise; nothing falls back to the eager loop, and
    the warm-up is undone."""
    (agent, _), (state, _), ring = _epoch_pair(cuda)
    core = agent.core
    real = core.predict_continuation

    def probe(latent):
        latent.sum().item()
        return real(latent)

    monkeypatch.setattr(core, "predict_continuation", probe)
    before = [p.detach().clone() for p in core.parameters()]
    with pytest.raises(RuntimeError):
        agent.train_epoch(state, ring, 2)
    torch.cuda.synchronize()
    assert state.step == 0 and agent.total_steps == 0
    assert all(o.count == 0 for o in state.optimizers.values())
    assert all(torch.equal(p, b) for p, b in zip(core.parameters(), before))


def test_a_dead_graph_cycle_does_not_break_a_capture(cuda):
    """A CUDA graph held only by a dead reference cycle, with the cyclic
    collector set to run at every allocation: a capture through
    ``capture_counted`` completes and replays (the collector is off while
    it captures), and the cycle goes at the next collection after it."""
    import gc
    import weakref

    from active_inference_diffusion_torch.agents.graphs import capture_counted

    x = torch.zeros(4, device=cuda)
    dead = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead):
        x.add_(1.0)
    cycle = {"graph": dead}
    cycle["self"] = cycle
    gone = weakref.ref(dead)
    del cycle, dead
    thresholds, alive = gc.get_threshold(), []

    def fn():
        alive.append(gone() is not None)
        gc.set_threshold(1, 1, 1)  # the collector would run at the next allocations
        for _ in range(50):
            x.mul_(torch.ones(4, device=cuda))
            [[] for _ in range(10)]

    graph = torch.cuda.CUDAGraph()
    try:
        capture_counted(graph, fn)
    finally:
        gc.set_threshold(*thresholds)
    assert alive == [True]  # the dead cycle outlived the capture's start
    graph.replay()
    torch.cuda.synchronize()
    gc.collect()
    assert gone() is None


def _dreamer_pair(cuda, warmup=3, batch=16):
    """hopper_state_dreamer.yaml cut to latent 8 / hidden 64 / 2 blocks:
    two agents with the same weights and fresh train states (the anchor's
    warm-up ``warmup`` steps), and a seeded ring on the card."""
    from active_inference_diffusion_torch import load_yaml_config

    agents, states = [], []
    for _ in range(2):
        cfg, training, _ = load_yaml_config("examples/configs/hopper_state_dreamer.yaml")
        cfg.latent_dim, cfg.hidden_dim, cfg.score_num_layers = 8, 64, 2
        cfg.batch_size, cfg.policy_anchor_warmup_steps = batch, warmup
        agents.append(DiffusionStateAgent(OBS_DIM, 2, cfg, training))
        states.append(agents[-1].init_train_state(0))
    ring = DeviceReplayBuffer(256, (OBS_DIM,), 2)
    rng = np.random.default_rng(5)
    ring.add_batch(rng.standard_normal((200, OBS_DIM)), np.tanh(rng.standard_normal((200, 2))),
                   rng.standard_normal(200), rng.standard_normal((200, OBS_DIM)),
                   rng.random(200) < 0.1)
    return agents, states, ring.state


def test_dreamer_graph_epoch_crosses_the_anchor_gate(cuda):
    """Hopper's flags, six updates from step 0 (MINE at 0 and 5, the
    anchor open from step 3) as graph replays in ONE ``train_epoch`` call,
    against the eager loop: every metric's mean, the parameters, and the
    state's fields, the slow critic, return scale, log_alpha and EMA policy
    among them; four kinds of update captured, no sweep launched."""
    (graph, eager), (gstate, estate), ring = _dreamer_pair(cuda)
    before = dict(LAUNCHES), dict(PLAIN_RUNS)
    gstate, got = graph.train_epoch(gstate, ring, 6)
    assert graph._epoch_graphs.captures == 4
    assert set(graph._epoch_graphs.captured) == {(True, False), (False, False), (False, True),
                                                 (True, True)}
    assert (dict(LAUNCHES), dict(PLAIN_RUNS)) == before
    estate, want = _eager_updates(eager, estate, ring, 6)
    for k in got:
        mean = torch.stack([w[k] for w in want]).mean()
        torch.testing.assert_close(got[k], mean, **TOL[torch.float32], msg=k)
    _assert_same_training(graph, gstate, eager, estate)
    for name in ("return_scale", "log_alpha"):
        torch.testing.assert_close(getattr(gstate, name), getattr(estate, name),
                                   **TOL[torch.float32], msg=name)
    assert float(gstate.return_scale) != 1.0
    for field in ("target_value", "ema_policy", "ema_score"):
        for k, v in getattr(gstate, field).items():
            torch.testing.assert_close(v, getattr(estate, field)[k], **TOL[torch.float32],
                                       msg=f"{field} {k}")
    # the anchor's gate is part of the graph's kind: an epoch with it closed
    # throughout differs from one where it opens
    (late, _), (lstate, _), _ = _dreamer_pair(cuda, warmup=100)
    lstate, _ = late.train_epoch(lstate, ring, 6)
    assert not torch.equal(lstate.ema_policy["mean_fc2.weight"], gstate.ema_policy["mean_fc2.weight"])


def test_acting_with_the_score_ema_packs_it_apart(cuda):
    """C4 on the card: with ``use_ema_for_act`` the sweep kernel runs the
    EMA's own pack; the live network's cached pack is never the EMA's; an
    in-place EMA update rebuilds the EMA's pack; the actions equal the CPU
    twin's acting with the same state."""
    cfg = ActiveInferenceConfig(observation_dim=OBS_DIM, action_dim=2, latent_dim=8,
                                hidden_dim=64, score_num_layers=2, use_ema_for_act=True,
                                deterministic_beliefs=True,
                                diffusion=DiffusionConfig(num_diffusion_steps=5))
    agent = DiffusionStateAgent(OBS_DIM, 2, cfg, TrainingConfig())
    state = agent.init_train_state(0)
    randomize(agent.core.score_network, 3)
    gen = torch.Generator(device=cuda).manual_seed(4)
    with torch.no_grad():
        for v in state.ema_score.values():
            v.add_(0.3 * torch.randn(v.shape, generator=gen, device=cuda))
    twin = DiffusionStateAgent(OBS_DIM, 2, cfg, TrainingConfig(), device="cpu")
    twin.core.load_state_dict(agent.core.state_dict())
    twin_state = twin.new_train_state(0)
    obs = np.random.default_rng(7).standard_normal((8, OBS_DIM)).astype(np.float32)
    name = kernel_name("v1", torch.float32)
    acts = []
    for _ in range(2):
        twin_state.ema_score = {k: v.cpu() for k, v in state.ema_score.items()}
        launches = LAUNCHES[name]
        got = agent.act(obs, torch.Generator(device=cuda).manual_seed(1), deterministic=True,
                        collect=False, state=state)
        assert LAUNCHES[name] == launches + 1
        start = agent.core.draw_start(8, torch.Generator(device=cuda).manual_seed(1))
        want, _ = twin.act_from_start(torch.from_numpy(obs), start.to("cpu"), None,
                                      deterministic=True, state=twin_state)
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-4, atol=1e-4)
        live_packs = agent.core.score_network.__dict__.get("_packed_trunks", {})
        ema_ptrs = {v.data_ptr() for v in state.ema_score.values()}
        assert all(not ema_ptrs & {p for p, _ in key} for key, _ in live_packs.values())
        acts.append(got)
        with torch.no_grad():
            for v in state.ema_score.values():
                v.mul_(0.5)
    assert not np.allclose(acts[0], acts[1])


# -- the fused collect and eval on the card (envs/collect_graph.py) ---------


def _fused_policy(cuda, env, warm=False, eps=0.3):
    """The Pendulum entry point's agent (train_fused's flag defaults, K=5),
    weights randomised, and its collect policy with exploration noise."""
    from active_inference_diffusion_torch.envs import device_envs as de

    cfg = ActiveInferenceConfig(observation_dim=env.observation_dim, action_dim=env.action_dim,
                                latent_dim=16, hidden_dim=64, score_num_layers=2,
                                diffusion=DiffusionConfig(num_diffusion_steps=5))
    agent = DiffusionStateAgent(env.observation_dim, env.action_dim, cfg, TrainingConfig())
    randomize(agent.core, 11)
    inner = (de.make_warm_rollout_policy(agent.core, env, num_steps=3) if warm
             else de.make_rollout_policy(agent.core, env))
    return agent, de.ExplorationNoise(inner, env, torch.tensor(eps, device=cuda))


def _eager_collect(env, policy, states, pstate, gen_state, num_envs, steps):
    from active_inference_diffusion_torch.envs import device_envs as de

    gen = torch.Generator(device=states.obs.device)
    gen.set_state(gen_state)
    fn = policy if policy.stateful else de.stateful(policy)
    return de.fused_collect_stateful(env, fn, de.draw_collect(env, policy, num_envs, steps, gen,
                                                              reset=False), pstate, states)


@pytest.mark.parametrize("warm", [False, True], ids=["sweep", "warm"])
def test_collect_graph_matches_the_eager_collect(cuda, warm):
    """Two collects of 6 steps of 32 Pendulum envs as graph replays against
    the eager steps on the same draws; one sweep launch per env step, none
    plain, the first collect (with the capture) and the second alike."""
    from active_inference_diffusion_torch.envs import device_envs as de
    from active_inference_diffusion_torch.envs.collect_graph import CollectGraph

    env = de.make_device_env("Pendulum-v1")
    agent, policy = _fused_policy(cuda, env, warm)
    gen = torch.Generator(device=cuda).manual_seed(5)
    states = env.reset(env.draw_reset(32, gen))
    pstate = de.init_warm_state(32, 16, gen) if warm else None
    collector = CollectGraph(env, policy, 32, 6)
    name = kernel_name("v1", torch.float32)
    for _ in range(2):
        snapshot, before = gen.get_state(), (LAUNCHES[name], PLAIN_RUNS[name])
        first = (de.EnvState(*[x.clone() for x in states.tensors()]),
                 None if pstate is None else pstate.clone())
        tr, states, pstate = collector.collect(states, pstate, gen)
        torch.cuda.synchronize()
        assert (LAUNCHES[name] - before[0], PLAIN_RUNS[name] - before[1]) == (6, 0)
        want, want_states, want_p = _eager_collect(env, policy, first[0], first[1], snapshot,
                                                   32, 6)
        for got, exp in zip(tr, want):
            torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(states.physics, want_states.physics, rtol=1e-6, atol=1e-6)
        if warm:
            torch.testing.assert_close(pstate, want_p, rtol=1e-6, atol=1e-6)
    assert collector.captures == 1 and collector.step_graph.replays == 11


def test_collect_graph_reads_eps_at_each_replay(cuda):
    """The exploration scale is a device tensor the host writes: a collect
    at eps 0.3 captures the step; the next collect at eps 0 equals the eager
    collect at eps 0, and not the one at 0.3."""
    from active_inference_diffusion_torch.envs import device_envs as de
    from active_inference_diffusion_torch.envs.collect_graph import CollectGraph

    env = de.make_device_env("Pendulum-v1")
    _, policy = _fused_policy(cuda, env, eps=0.3)
    gen = torch.Generator(device=cuda).manual_seed(6)
    states = env.reset(env.draw_reset(16, gen))
    collector = CollectGraph(env, policy, 16, 3)
    _, states, _ = collector.collect(states, None, gen)
    policy.eps.fill_(0.0)
    snapshot = gen.get_state()
    first = de.EnvState(*[x.clone() for x in states.tensors()])
    tr, _, _ = collector.collect(states, None, gen)
    want, _, _ = _eager_collect(env, policy, first, None, snapshot, 16, 3)
    torch.testing.assert_close(tr.actions, want.actions, rtol=1e-6, atol=1e-6)
    policy.eps.fill_(0.3)
    noisy, _, _ = _eager_collect(env, policy, first, None, snapshot, 16, 3)
    assert not torch.allclose(tr.actions, noisy.actions)


def test_planar_collect_and_eval_graphs_match_eager(cuda):
    """HopperPlanar-v0, 8 envs: a collect of 3 steps as graph replays
    against the eager steps, the physics finite; an eval of 4 steps against
    ``fused_eval`` on the same draws."""
    from active_inference_diffusion_torch.envs import device_envs as de
    from active_inference_diffusion_torch.envs.collect_graph import CollectGraph, EvalGraph

    env = de.make_device_env("HopperPlanar-v0")
    agent, policy = _fused_policy(cuda, env)
    gen = torch.Generator(device=cuda).manual_seed(7)
    states = env.reset(env.draw_reset(8, gen))
    first, snapshot = de.EnvState(*[x.clone() for x in states.tensors()]), gen.get_state()
    tr, states, _ = CollectGraph(env, policy, 8, 3).collect(states, None, gen)
    want, want_states, _ = _eager_collect(env, policy, first, None, snapshot, 8, 3)
    assert torch.isfinite(states.physics).all()
    for got, exp in zip(tr, want):
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)
    evaluator = de.make_rollout_policy(agent.core, env, deterministic=True)
    snapshot = gen.get_state()
    got = EvalGraph(env, evaluator, 8, 4).evaluate(gen)
    gen.set_state(snapshot)
    exp = de.fused_eval(env, evaluator, de.draw_eval(env, evaluator, 8, 4, gen))
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=1e-5)


def test_a_collect_capture_that_fails_raises(cuda):
    """A step that reads the device from the host cannot be captured: the
    collect raises instead of running it eagerly."""
    from active_inference_diffusion_torch.envs import device_envs as de
    from active_inference_diffusion_torch.envs.collect_graph import CollectGraph

    env = de.make_device_env("Pendulum-v1")

    class Syncing:
        stateful = False

        def draw(self, n, generator):
            return torch.randn((n, 1), generator=generator, device=cuda)

        def __call__(self, obs, noise):
            return noise * float(obs.abs().max())  # a host read

    gen = torch.Generator(device=cuda).manual_seed(8)
    states = env.reset(env.draw_reset(4, gen))
    with pytest.raises(RuntimeError, match="capturing the env step failed"):
        CollectGraph(env, Syncing(), 4, 2).collect(states, None, gen)


def test_rigid3d_collect_graph_matches_the_eager_collect(cuda):
    """Ant3D-v0, 16 envs: two collects of 4 steps with the sweep acting as
    graph replays against the eager steps on the same draws; one sweep
    launch per env step, none plain; the physics finite."""
    from active_inference_diffusion_torch.envs import device_envs as de
    from active_inference_diffusion_torch.envs.collect_graph import CollectGraph

    env = de.make_device_env("Ant3D-v0")
    _, policy = _fused_policy(cuda, env)
    gen = torch.Generator(device=cuda).manual_seed(9)
    states = env.reset(env.draw_reset(16, gen))
    collector = CollectGraph(env, policy, 16, 4)
    name = kernel_name("v1", torch.float32)
    for _ in range(2):
        snapshot, before = gen.get_state(), (LAUNCHES[name], PLAIN_RUNS[name])
        first = de.EnvState(*[x.clone() for x in states.tensors()])
        tr, states, _ = collector.collect(states, None, gen)
        torch.cuda.synchronize()
        assert (LAUNCHES[name] - before[0], PLAIN_RUNS[name] - before[1]) == (4, 0)
        want, want_states, _ = _eager_collect(env, policy, first, None, snapshot, 16, 4)
        for got, exp in zip(tr, want):
            torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(states.physics, want_states.physics, rtol=1e-6, atol=1e-6)
        assert torch.isfinite(states.physics).all()
    assert collector.captures == 1


def test_humanoid_step_captures_with_no_host_sync(cuda):
    """A Humanoid3D-v0 env step with autoreset runs with CUDA's sync debug
    mode set to raise, then is captured and replayed: the replay equals the
    eager step."""
    from active_inference_diffusion_torch.envs import device_envs as de
    from active_inference_diffusion_torch.envs.collect_graph import StepGraph

    env = de.make_device_env("Humanoid3D-v0")
    gen = torch.Generator(device=cuda).manual_seed(10)
    state = env.reset(env.draw_reset(8, gen))
    action = torch.rand((8, env.action_dim), generator=gen, device=cuda) * 0.8 - 0.4
    reset = env.draw_reset(8, gen)
    torch.cuda.set_sync_debug_mode("error")
    try:
        want, want_obs = env.step_autoreset(state, action, reset)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out = {}

    def step():
        out["state"], out["obs"] = env.step_autoreset(state, action, reset)

    graph = StepGraph(step, cuda)
    graph()
    graph()
    torch.testing.assert_close(out["obs"], want_obs, rtol=0, atol=0)
    torch.testing.assert_close(out["state"].physics, want.physics, rtol=0, atol=0)
    assert graph.graph is not None and graph.replays == 1
