"""Port parity: the belief sweep, in all four variants.

The port's plain sweep (the CUDA kernels' plain version, which the wrappers
run for CPU tensors) is held against the JAX Pallas kernels in interpret
mode, as tests/test_pallas_denoise.py runs them: v1 and v2, float32 at
``MODEL_TOL`` (rtol 2e-4 / atol 2e-5), bfloat16 weights at ``BF16_TOL``
(see tests/torch_parity.py). The stochastic sweep is held against a JAX
loop of ``trunk`` + ``p_sample`` with the same numpy noise, and the port's
v2 against its v1 with the same in-sweep noise. The kernels themselves are
held against this plain version on the card, in
tests/test_torch_kernel_cuda.py and chip_smoke.py.
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
    extract_trunk_weights_v2 as jax_extract_trunk_weights_v2,
)
from active_inference_diffusion_tpu.ops.denoise import (
    fused_denoise_sweep as jax_fused_denoise_sweep,
)
from active_inference_diffusion_tpu.ops.denoise import (
    fused_denoise_sweep_v2 as jax_fused_denoise_sweep_v2,
)
from active_inference_diffusion_torch.bridge import load_jax_params
from active_inference_diffusion_torch.ops.denoise import (
    LAUNCHES,
    MAX_SMEM_BYTES,
    denoise_sweep_reference,
    extract_trunk_weights,
    fused_denoise_sweep,
    fused_denoise_sweep_v2,
    packed_trunk_weights,
    philox4x32,
    philox_normal,
    sweep_smem_bytes,
    sweep_v2_scratch_floats,
)
from torch_parity import (
    BF16_TOL,
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
# (variant, weight type) -> (port wrapper, JAX wrapper, JAX compute dtype)
VARIANTS = {
    ("v1", torch.float32): (fused_denoise_sweep, jax_fused_denoise_sweep, jnp.float32),
    ("v1", torch.bfloat16): (fused_denoise_sweep, jax_fused_denoise_sweep, jnp.bfloat16),
    ("v2", torch.float32): (fused_denoise_sweep_v2, jax_fused_denoise_sweep_v2, jnp.float32),
    ("v2", torch.bfloat16): (fused_denoise_sweep_v2, jax_fused_denoise_sweep_v2, jnp.bfloat16),
}


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


def port_sweep(tcore, variant, dtype, z0, obs_emb, t_embs, num_steps, deterministic,
               seed=SEED):
    wrapper = VARIANTS[(variant, dtype)][0]
    return wrapper(
        tcore.schedule, packed_trunk_weights(tcore.score_network, variant, dtype), t(z0),
        t(obs_emb), t(t_embs), seed, num_steps=num_steps, num_layers=L,
        deterministic=deterministic,
    )


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
    got = port_sweep(tcore, "v1", torch.float32, z0, obs_emb, t_embs, num_steps, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **MODEL_TOL)


@pytest.mark.parametrize(
    "variant,dtype,tol",
    [("v1", torch.bfloat16, BF16_TOL), ("v2", torch.float32, MODEL_TOL),
     ("v2", torch.bfloat16, BF16_TOL)],
    ids=["v1-bf16", "v2-f32", "v2-bf16"],
)
def test_plain_sweep_variants_match_pallas_interpret(cores, variant, dtype, tol):
    """The bfloat16 mode of v1 and both modes of v2 against the JAX kernels
    in interpret mode (deterministic; interpret mode has no TPU PRNG)."""
    jcore, params, tcore = cores
    z0, obs = normal(10, B, D), normal(11, B, OBS_DIM)
    obs_emb, t_embs = embeddings(jcore, params, obs, K)
    _, jax_wrapper, jax_dtype = VARIANTS[(variant, dtype)]
    expected = jax_wrapper(
        jcore.schedule, params["score"], z0, obs_emb, t_embs,
        seed=jnp.asarray(0), num_steps=K, num_layers=L,
        deterministic=True, interpret=True, compute_dtype=jax_dtype,
    )
    got = port_sweep(tcore, variant, dtype, z0, obs_emb, t_embs, K, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), **tol)
    if dtype == torch.bfloat16:  # the rounding is there: bf16 is not the f32 sweep
        f32 = port_sweep(tcore, variant, torch.float32, z0, obs_emb, t_embs, K, True)
        assert not torch.allclose(got, f32, rtol=1e-5, atol=1e-6)


# bfloat16 v2 and v1 round at different sites (v1 rounds v_proj's output
# before out_proj, v2 rounds the composed Wv @ Wo), so they agree only to the
# rounding itself: the JAX package's bf16-vs-f32 tolerance.
@pytest.mark.parametrize(
    "dtype,tol",
    [(torch.float32, MODEL_TOL), (torch.bfloat16, dict(rtol=0.1, atol=0.05))],
    ids=["f32", "bf16"],
)
@pytest.mark.parametrize("deterministic", [True, False], ids=["det", "sto"])
def test_v2_matches_v1(cores, dtype, tol, deterministic):
    """v2's algebra is exact up to float reassociation in float32; both
    variants draw the same in-sweep noise, so the stochastic sweeps agree
    too."""
    jcore, params, tcore = cores
    z0, obs = normal(12, 13, D), normal(13, 13, OBS_DIM)
    obs_emb, t_embs = embeddings(jcore, params, obs, K)
    v1 = port_sweep(tcore, "v1", dtype, z0, obs_emb, t_embs, K, deterministic)
    v2 = port_sweep(tcore, "v2", dtype, z0, obs_emb, t_embs, K, deterministic)
    np.testing.assert_allclose(v2.numpy(), v1.numpy(), **tol)


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

    def run(seed, deterministic=False):
        return port_sweep(tcore, "v1", torch.float32, z0, obs_emb, t_embs, K, deterministic,
                          torch.tensor(seed, dtype=torch.int64))

    assert torch.equal(run(3), run(3))
    assert not torch.allclose(run(3), run(4))
    assert torch.equal(run(3, True), run(4, True))


def test_packed_weights_round_trip_and_cache(cores):
    jcore, params, tcore = cores
    net = tcore.score_network
    packed = packed_trunk_weights(net)
    for buf in (packed.weights, packed.biases):
        assert buf.is_contiguous() and buf.dim() == 1 and buf.dtype == torch.float32
    assert packed_trunk_weights(net) is packed  # cached
    expected = jax_extract_trunk_weights(params["score"], L)
    views = packed.views()
    for name, value in extract_trunk_weights(net).items():
        if name == "output_multiplier":
            assert packed.output_multiplier == pytest.approx(float(value[0]))
            continue
        assert torch.equal(views[name], value)
        np.testing.assert_array_equal(views[name].numpy(), np.asarray(expected[name]))
    # v2 and bfloat16 packs are cached beside it, keyed by variant and type
    expected_v2 = jax_extract_trunk_weights_v2(params["score"], L)
    for variant in ("v1", "v2"):
        for dtype in (torch.float32, torch.bfloat16):
            p = packed_trunk_weights(net, variant, dtype)
            assert p.variant == variant and p.dtype == dtype and p.biases.dtype == torch.float32
            assert packed_trunk_weights(net, variant, dtype) is p
            for name, (off, _) in p.offsets.items():  # 16-byte aligned
                buf = p.weights if name.endswith("_w") else p.biases
                assert (off * buf.element_size()) % 16 == 0
            ref = expected if variant == "v1" else expected_v2
            for name, view in p.views().items():
                want = np.asarray(ref[name], np.float32)
                if name.endswith("_w") and dtype == torch.bfloat16:
                    want = t(want).to(torch.bfloat16).float().numpy()
                # vo_w / vo_b are products composed in float32 by each package
                tol = MODEL_TOL if name.startswith("vo_") else dict(rtol=0, atol=0)
                if name.startswith("vo_w") and dtype == torch.bfloat16:
                    tol = dict(rtol=2**-8, atol=1e-6)  # one bf16 rounding may differ
                np.testing.assert_allclose(view.float().numpy(), want, err_msg=name, **tol)
    # loading weights again rebuilds the pack
    load_jax_params(tcore, perturbed(params, seed=1))
    repacked = packed_trunk_weights(net)
    assert repacked is not packed
    assert not torch.equal(repacked.weights, packed.weights)
    load_jax_params(tcore, params)
    assert torch.equal(packed_trunk_weights(net).weights, packed.weights)


def test_cpu_wrapper_runs_plain_version_without_counting(cores):
    jcore, params, tcore = cores
    z0, obs = normal(8, B, D), normal(9, B, OBS_DIM)
    obs_emb, t_embs = embeddings(jcore, params, obs, K)
    before = dict(LAUNCHES)
    for variant, dtype in VARIANTS:
        packed = packed_trunk_weights(tcore.score_network, variant, dtype)
        wrapper = VARIANTS[(variant, dtype)][0]
        got = wrapper(tcore.schedule, packed, t(z0), t(obs_emb), t(t_embs), SEED, K, L, False)
        ref = denoise_sweep_reference(
            tcore.schedule, packed, t(z0), t(obs_emb), t(t_embs), SEED, K, L, False
        )
        assert torch.equal(got, ref)
    assert LAUNCHES == before
    packed = packed_trunk_weights(tcore.score_network)
    with pytest.raises(ValueError, match="t_embs"):
        fused_denoise_sweep(
            tcore.schedule, packed, t(z0), t(obs_emb), t(t_embs[:3]), SEED, K, L, False
        )
    with pytest.raises(TypeError, match="float32"):
        fused_denoise_sweep(
            tcore.schedule, packed, t(z0).double(), t(obs_emb), t(t_embs), SEED, K, L, False
        )
    with pytest.raises(ValueError, match="packed for v1"):  # v2 never runs v1 weights
        fused_denoise_sweep_v2(
            tcore.schedule, packed, t(z0), t(obs_emb), t(t_embs), SEED, K, L, False
        )


def test_shared_memory_plan():
    """The kernels' per-block plans: TB rows x (2 padded latents + 9 H)
    float32 for v1, (2 padded latents + 7 H) for v2, whose TB x (L*4H + 2H)
    modulations live in device scratch. The flagship, halfcheetah_state.yaml
    and humanoid_state.yaml widths fit 227 KB; hidden 512 does not, and the
    CUDA wrappers raise for it."""
    assert sweep_smem_bytes(32, 128) == 4 * 16 * (2 * 32 + 9 * 128)
    assert sweep_smem_bytes(50, 256) == 4 * 16 * (2 * 52 + 9 * 256)
    assert sweep_smem_bytes(64, 256) == 155_648 <= MAX_SMEM_BYTES
    assert sweep_smem_bytes(64, 256, "v2") == 4 * 16 * (2 * 64 + 7 * 256)
    assert sweep_smem_bytes(128, 512) > MAX_SMEM_BYTES
    assert sweep_smem_bytes(128, 512, "v2") > MAX_SMEM_BYTES
    # humanoid width, B=256: 16 blocks x 16 rows x (6*4*256 + 2*256) floats = 6.8 MB
    assert 4 * sweep_v2_scratch_floats(256, 256, 6) == 6_815_744
    assert sweep_v2_scratch_floats(37, 128, 6) == 48 * (6 * 4 + 2) * 128
