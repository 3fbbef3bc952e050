"""Port parity: the belief sweep.

The port's plain sweep (the CUDA kernel's plain version, which the wrapper
runs for CPU tensors) is held against the JAX Pallas kernel in interpret
mode, as tests/test_pallas_denoise.py runs it, at rtol 2e-4 / atol 2e-5.
The stochastic sweep is held against a JAX loop of ``trunk`` +
``p_sample`` with the same numpy noise. The kernel itself is held against this plain version on the card, in
tests/test_torch_kernel_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.core import diffusion as jdiff
from active_inference_diffusion_tpu.ops.denoise import (
    extract_trunk_weights as jax_extract_trunk_weights,
)
from active_inference_diffusion_tpu.ops.denoise import (
    fused_denoise_sweep as jax_fused_denoise_sweep,
)
from active_inference_diffusion_torch.bridge import load_jax_params
from active_inference_diffusion_torch.ops.denoise import (
    MAX_SMEM_BYTES,
    denoise_sweep_reference,
    extract_trunk_weights,
    fused_denoise_sweep,
    packed_trunk_weights,
    philox4x32,
    philox_normal,
    sweep_smem_bytes,
)
from torch_parity import (
    MODEL_TOL,
    OBS_DIM,
    B,
    D,
    K,
    L,
    jax_core_and_params,
    normal,
    perturbed,
    t,
    tiny_config,
    torch_core,
)

SEED = torch.tensor(1234, dtype=torch.int64)


@pytest.fixture(scope="module")
def cores():
    cfg = tiny_config()
    jcore, params = jax_core_and_params(cfg)
    return jcore, params, torch_core(cfg, params)


def embeddings(jcore, params, obs, num_steps):
    """JAX obs embedding and the discrete time embeddings of t = K-1..0."""
    variables = {"params": params["score"]}
    obs_emb = jcore.score_network.apply(variables, obs, method="obs_embedding")
    steps = jnp.arange(num_steps - 1, -1, -1).astype(jnp.float32)
    t_embs = jcore.score_network.apply(
        variables, steps, continuous=False, method="time_embedding"
    )
    return np.asarray(obs_emb), np.asarray(t_embs)


@pytest.mark.parametrize(
    "batch,num_steps", [(B, K), (B, 3), (13, K)], ids=["full", "partial", "ragged"]
)
def test_plain_sweep_matches_pallas_interpret(cores, batch, num_steps):
    jcore, params, tcore = cores
    z0, obs = normal(1, batch, D), normal(2, batch, OBS_DIM)
    obs_emb, t_embs = embeddings(jcore, params, obs, num_steps)
    expected = jax_fused_denoise_sweep(
        jcore.schedule, params["score"], z0, obs_emb, t_embs,
        seed=jnp.asarray(0), num_steps=num_steps, num_layers=L,
        deterministic=True, interpret=True,
    )
    got = fused_denoise_sweep(
        tcore.schedule, packed_trunk_weights(tcore.score_network), t(z0), t(obs_emb),
        t(t_embs), SEED, num_steps=num_steps, num_layers=L, deterministic=True,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **MODEL_TOL)


def test_stochastic_plain_sweep_matches_jax_loop(cores):
    """Same numpy noise into the port's plain sweep and a JAX loop of trunk +
    p_sample (noise enters at t > 0 only)."""
    jcore, params, tcore = cores
    z0, obs = normal(3, B, D), normal(4, B, OBS_DIM)
    noise = normal(5, K, B, D)
    obs_emb, t_embs = embeddings(jcore, params, obs, K)
    z = jnp.asarray(z0)
    for i in range(K):
        cond = obs_emb + t_embs[i][None, :]
        score = jcore.score_network.apply(
            {"params": params["score"]}, z, cond, None, method="trunk"
        )
        steps = jnp.full((B,), K - 1 - i, dtype=jnp.int32)
        z = jdiff.p_sample(jcore.schedule, z, steps, score, noise[i], deterministic=False)
    got = denoise_sweep_reference(
        tcore.schedule, packed_trunk_weights(tcore.score_network), t(z0), t(obs_emb),
        t(t_embs), SEED, num_steps=K, num_layers=L, deterministic=False, noise=t(noise),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(z), **MODEL_TOL)


def test_philox_known_answers():
    """Philox4x32-10 known-answer vectors of the Random123 suite."""
    cases = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        (
            (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
            (0xA4093822, 0x299F31D0),
            (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
        ),
    ]
    for counter, key, expected in cases:
        out = philox4x32(
            tuple(torch.tensor(c) for c in counter), tuple(torch.tensor(k) for k in key)
        )
        assert tuple(int(o) for o in out) == expected


def test_philox_normal_finite_and_standard():
    """The in-sweep noise is finite and standard normal, over rows and steps,
    including the largest seed."""
    rows = torch.arange(512)[:, None]
    cols = torch.arange(64)[None, :]
    for seed in (0, 2**31 - 2):
        draws = torch.stack(
            [philox_normal(torch.tensor(seed), rows, step, cols) for step in range(4)]
        )
        assert torch.isfinite(draws).all()
        assert abs(float(draws.mean())) < 0.02
        assert abs(float(draws.std()) - 1.0) < 0.02
    # the draw is a function of (seed, row, step, col) alone: no batch tiling
    one = philox_normal(torch.tensor(7), torch.tensor([[300]]), 2, torch.tensor([[5]]))
    many = philox_normal(torch.tensor(7), rows, 2, cols)
    assert float(one) == float(many[300, 5])


def test_stochastic_sweep_seeds(cores):
    jcore, params, tcore = cores
    z0, obs = normal(6, B, D), normal(7, B, OBS_DIM)
    obs_emb, t_embs = embeddings(jcore, params, obs, K)
    packed = packed_trunk_weights(tcore.score_network)

    def run(seed, deterministic=False):
        return fused_denoise_sweep(
            tcore.schedule, packed, t(z0), t(obs_emb), t(t_embs),
            torch.tensor(seed, dtype=torch.int64), K, L, deterministic,
        )

    assert torch.equal(run(3), run(3))
    assert not torch.allclose(run(3), run(4))
    assert torch.equal(run(3, True), run(4, True))


def test_packed_weights_round_trip_and_cache(cores):
    jcore, params, tcore = cores
    net = tcore.score_network
    packed = packed_trunk_weights(net)
    assert packed.buffer.is_contiguous() and packed.buffer.dim() == 1
    assert packed_trunk_weights(net) is packed  # cached
    expected = jax_extract_trunk_weights(params["score"], L)
    views = packed.views()
    for name, value in extract_trunk_weights(net).items():
        if name == "output_multiplier":
            assert packed.output_multiplier == pytest.approx(float(value[0]))
            continue
        assert torch.equal(views[name], value)
        np.testing.assert_array_equal(views[name].numpy(), np.asarray(expected[name]))
    for off, _ in packed.offsets.values():
        assert off % 4 == 0  # 16-byte aligned
    # loading weights again rebuilds the buffer
    load_jax_params(tcore, perturbed(params, seed=1))
    repacked = packed_trunk_weights(net)
    assert repacked is not packed
    assert not torch.equal(repacked.buffer, packed.buffer)
    load_jax_params(tcore, params)
    assert torch.equal(packed_trunk_weights(net).buffer, packed.buffer)


def test_cpu_wrapper_runs_plain_version_without_counting(cores):
    jcore, params, tcore = cores
    z0, obs = normal(8, B, D), normal(9, B, OBS_DIM)
    obs_emb, t_embs = embeddings(jcore, params, obs, K)
    packed = packed_trunk_weights(tcore.score_network)
    before = fused_denoise_sweep.launches
    got = fused_denoise_sweep(
        tcore.schedule, packed, t(z0), t(obs_emb), t(t_embs), SEED, K, L, False
    )
    ref = denoise_sweep_reference(
        tcore.schedule, packed, t(z0), t(obs_emb), t(t_embs), SEED, K, L, False
    )
    assert torch.equal(got, ref)
    assert fused_denoise_sweep.launches == before
    with pytest.raises(ValueError, match="t_embs"):
        fused_denoise_sweep(
            tcore.schedule, packed, t(z0), t(obs_emb), t(t_embs[:3]), SEED, K, L, False
        )
    with pytest.raises(TypeError, match="float32"):
        fused_denoise_sweep(
            tcore.schedule, packed, t(z0).double(), t(obs_emb), t(t_embs), SEED, K, L, False
        )


def test_shared_memory_plan():
    """The kernel's per-block plan: TB rows x (2 padded latents + 9 H)
    float32. The flagship and halfcheetah_state.yaml widths fit 227 KB;
    hidden 512 does not, and the CUDA wrapper raises for it."""
    assert sweep_smem_bytes(32, 128) == 4 * 16 * (2 * 32 + 9 * 128)
    assert sweep_smem_bytes(50, 256) == 4 * 16 * (2 * 52 + 9 * 256)
    assert sweep_smem_bytes(50, 256) <= MAX_SMEM_BYTES
    assert sweep_smem_bytes(128, 512) > MAX_SMEM_BYTES
