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

import functools

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
from active_inference_diffusion_torch.models.score_network import LatentScoreNetwork
from active_inference_diffusion_torch.ops.denoise import (
    CHUNK_TILES,
    KERNEL_CLUSTER,
    LAUNCHES,
    MAX_PIECES,
    MAX_SMEM_BYTES,
    SLOT_BYTES,
    K_STEP,
    ROW_PAD,
    STAGES,
    denoise_sweep_reference,
    extract_trunk_weights,
    fused_denoise_sweep,
    fused_denoise_sweep_v2,
    kernel_plan,
    kernel_products,
    kernel_shapes,
    kernel_smem_bytes,
    packed_trunk_weights,
    philox4x32,
    philox_normal,
    rank_columns,
    kernel_takes,
    sweep_smem_bytes,
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


def test_pack_views_the_output_multiplier(cores):
    """R1: every pack's ``output_multiplier`` is a 0-d float32 tensor that
    views the score network's parameter, so an in-place change reaches the
    sweep without a repack; nothing on the pack or launch path reads a
    tensor to the host."""
    import inspect
    import re

    from active_inference_diffusion_torch.ops import denoise

    net = cores[2].score_network
    for variant in ("v1", "v2"):
        mult = packed_trunk_weights(net, variant).output_multiplier
        assert isinstance(mult, torch.Tensor) and mult.dim() == 0 and mult.dtype == torch.float32
        assert mult.data_ptr() == net.output_multiplier.data_ptr()
    packed = packed_trunk_weights(net)
    h = packed.hidden_dim
    args = (cores[2].schedule, packed, t(normal(8, B, D)), torch.zeros(B, h), torch.zeros(K, h),
            torch.tensor(0), K, L)
    before = denoise.denoise_sweep_reference(*args, deterministic=True)
    saved = float(net.output_multiplier)
    with torch.no_grad():
        net.output_multiplier.fill_(saved * 3.0)
    try:
        moved = denoise.denoise_sweep_reference(*args, deterministic=True)
    finally:
        with torch.no_grad():
            net.output_multiplier.fill_(saved)
    assert float(packed.output_multiplier) == pytest.approx(saved)
    assert not torch.allclose(before, moved)
    path = (denoise.extract_trunk_weights, denoise.extract_trunk_weights_v2,
            denoise.pack_trunk_weights, denoise.packed_trunk_weights, denoise.kernel_layout,
            denoise.sweep_coefficients, denoise._check_args, denoise._sweep)
    for fn in path:  # a host read: the builtin float() of a tensor, .item(), or a copy out
        source = inspect.getsource(fn)
        assert not re.search(r"(?<![.\w])float\(|\.item\(|\.cpu\(|\.tolist\(|\.numpy\(",
                             source), fn.__name__


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
            assert float(packed.output_multiplier) == pytest.approx(float(value[0]))
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
    """The float32 kernels' plan per CTA of a cluster, either variant: the
    bfloat16 plan with float32 operand copies (rows padded by 16 bytes, 4
    floats). At latent 64, hidden 256 (halfcheetah_state.yaml's latent 50
    pads to 64) it fits the 232,448 B a block may use, with the MLP hidden's
    copy 65,792 B of it; the flagship fits; hidden 512 does not, and hidden
    widths that are not a multiple of 64 are refused."""
    c = KERNEL_CLUSTER
    fixed = STAGES * SLOT_BYTES + 64 + 8 * MAX_PIECES + 2 * 4 * 16 * (8 * CHUNK_TILES + 8)
    # operands: latent (64 + 4), silu(cond) and x (256 + 4), MLP hidden (1024 + 4), in
    # float32; the rank's slices of h, of the modulation and of z; the adaLN statistics
    activations = 16 * (4 * (68 + 2 * 260 + 1028) + 4 * (256 + 512 + 64) // c + 8 * c)
    assert 16 * 4 * (1024 + ROW_PAD // 4) == 65_792
    for variant in ("v1", "v2"):
        humanoid = kernel_smem_bytes(64, 256, variant, torch.float32)
        assert humanoid == fixed + activations == 230_464 <= MAX_SMEM_BYTES
        assert kernel_smem_bytes(50, 256, variant, torch.float32) == humanoid
        assert kernel_smem_bytes(32, 128, variant, torch.float32) < humanoid
        with pytest.raises(ValueError, match="shared memory"):
            kernel_smem_bytes(64, 512, variant, torch.float32)
        with pytest.raises(ValueError, match="multiple of 64"):
            kernel_smem_bytes(8, 32, variant, torch.float32)
    assert sweep_smem_bytes(64, 256) == sweep_smem_bytes(64, 256, torch.float32) == 230_464


# ---------------------------------------------------------------------------
# The kernels' weight layout and shared-memory plan (no JAX)
# ---------------------------------------------------------------------------

# (latent, hidden, layers): a small width the kernels take (latent padded from
# 50 to 64), the humanoid_state.yaml width, and a hidden width the kernels pad
# (96 to 128; out_fc1's 48 to 64).
LAYOUT_WIDTHS = {"small": (50, 64, 2), "humanoid": (64, 256, 6), "padded": (32, 96, 2)}
# Integer words of each weight type, for comparing bit patterns.
WORDS = {torch.bfloat16: torch.int16, torch.float32: torch.int32}


@functools.lru_cache(maxsize=None)
def seeded_pack(variant, latent, hidden, layers, dtype):
    """A pack of seeded normal weights, built once per process per arguments."""
    net = LatentScoreNetwork(latent, OBS_DIM, hidden_dim=hidden, num_layers=layers)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(hidden + layers)
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return packed_trunk_weights(net, variant, dtype)


def unpack_kernel_layout(packed):
    """Plain inverse of the kernel order: per product, the (in, out) matrix
    padded with zeros as the kernels see it, written element by element from
    the piece table and the B-fragment rule W[k_step ks + k_of(t), 8 nt + g]
    = fragment[nt][ks][lane = 4 g + t][...], with k_of(t) = 2t + {0, 1, 8,
    9} for bfloat16 (m16n8k16) and t + {0, 4} for float32 (m16n8k8), and per
    product and rank the biases of the rank's columns, from the head of each
    chunk's first piece."""
    layout = packed.kernel
    word = WORDS[packed.dtype]
    words = layout.weights.view(word)
    size = words.element_size()
    table = layout.pieces.tolist()
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    if packed.dtype == torch.bfloat16:
        k_step, k_of = 16, torch.stack([2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], dim=1)
    else:
        k_step, k_of = 8, torch.stack([t, t + 4], dim=1)  # (lane, values a lane)
    per_lane = k_of.shape[1]
    n_of = g[:, None].expand(32, per_lane)
    mats, biases, index = [], [], 0
    for (w, _, modulation), (kp, np_) in zip(kernel_products(packed), kernel_shapes(packed)):
        out = torch.zeros(kp, np_, dtype=word)
        rank_biases = []
        for r in range(KERNEL_CLUSTER):
            cols = rank_columns(np_, modulation, r)
            k_steps, n_tiles, piece = kp // k_step, len(cols) // 8, index
            bias = []
            for n0 in range(0, n_tiles, CHUNK_TILES):
                ntc = min(CHUNK_TILES, n_tiles - n0)
                kb = 0
                while kb < k_steps:
                    off, nbytes = table[r][piece]
                    data = words[off * 16 // size : (off * 16 + nbytes) // size]
                    head = 32 * ntc // size
                    if kb == 0:  # the chunk's biases, then its fragments
                        bias.append(data[:head].clone().view(torch.float32))
                        data = data[head:]
                    ksp = data.numel() // (ntc * 32 * per_lane)
                    frags = data.view(ntc, ksp, 32, per_lane)
                    nt = torch.arange(ntc)[:, None, None, None]
                    kk = torch.arange(ksp)[None, :, None, None]
                    out[k_step * (kb + kk) + k_of, cols[8 * (n0 + nt) + n_of]] = frags
                    kb += ksp
                    piece += 1
            rank_biases.append(torch.cat(bias))
        index = piece
        mats.append(out.view(packed.dtype))
        biases.append(rank_biases)
    assert index == len(table[0])
    return mats, biases


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("width", sorted(LAYOUT_WIDTHS))
def test_kernel_layout_unpacks_to_the_views(variant, width, dtype):
    """The kernels' weight buffer holds exactly the (in, out) views, bit for
    bit, and zeros where the kernels pad (a modulation's scale and shift
    halves each padded at its end); each rank's bias heads hold the bias
    views of its columns, zeros where padded."""
    packed = seeded_pack(variant, *LAYOUT_WIDTHS[width], dtype)
    layout = packed.kernel
    assert layout.weights.dtype == dtype
    assert layout.pieces.shape[0] == KERNEL_CLUSTER and layout.pieces.shape[1] <= MAX_PIECES
    offsets, sizes = layout.pieces[..., 0].long() * 16, layout.pieces[..., 1].long()
    assert bool((sizes % 16 == 0).all()) and int(sizes.max()) <= SLOT_BYTES
    assert int((offsets + sizes).max()) == layout.weights.numel() * layout.weights.element_size()
    mats, biases = unpack_kernel_layout(packed)
    for (w, b, modulation), got, rank_biases in zip(kernel_products(packed), mats, biases):
        k, n = w.shape
        np_ = got.shape[1]
        word = WORDS[dtype]
        # padded column j of the kernels' matrix -> the view's column (-1: a zero column)
        source = torch.full((np_,), -1)
        if modulation:
            half = torch.arange(n // 2)
            source[half], source[np_ // 2 + half] = half, n // 2 + half
        else:
            source[:n] = torch.arange(n)
        real = source >= 0
        assert torch.equal(got[:k, real].view(word), w[:, source[real]].contiguous().view(word))
        assert not got[k:].float().any() and not got[:, ~real].float().any()
        for r in range(KERNEL_CLUSTER):
            cols = rank_columns(np_, modulation, r)
            want = torch.zeros(len(cols))
            src = source[cols]
            if b is not None:
                want[src >= 0] = b[src[src >= 0]]
            assert torch.equal(rank_biases[r], want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("width", sorted(LAYOUT_WIDTHS))
def test_every_output_column_has_one_rank(width, dtype):
    """Each product's columns (padded to 8 x KERNEL_CLUSTER) are split over
    the ranks without overlap or gap; a rank's slice is whole n-tiles, and a
    modulation's rank owns the scale and the shift of the same h-columns. In
    the pack of each weight type, each rank's pieces hold exactly its
    columns: their biases and one B fragment per (n-tile, k-step)."""
    latent, hidden, layers = LAYOUT_WIDTHS[width]
    packed = seeded_pack("v1", latent, hidden, layers, dtype)
    sizes = packed.kernel.pieces[..., 1].long().sum(dim=1)
    for r in range(KERNEL_CLUSTER):
        want = 0
        for (_, _, modulation), (kp, np_) in zip(kernel_products(packed), kernel_shapes(packed)):
            n_tiles = len(rank_columns(np_, modulation, r)) // 8
            k_steps = kp // K_STEP[dtype]
            want += 32 * n_tiles + n_tiles * k_steps * 32 * 8
        assert int(sizes[r]) == want
    hidden = -(-hidden // 64) * 64  # the kernels' hidden width
    for out, modulation in ((latent, False), (hidden, False), (4 * hidden, False),
                            (hidden // 2, False), (2 * hidden, True)):
        owners = torch.cat([rank_columns(out, modulation, r) for r in range(KERNEL_CLUSTER)])
        padded = -(-out // 64) * 64
        assert torch.equal(owners.sort().values, torch.arange(padded))
        for r in range(KERNEL_CLUSTER):
            cols = rank_columns(out, modulation, r)
            assert len(cols) % 8 == 0 and len(cols) == padded // KERNEL_CLUSTER
            if modulation:
                half = len(cols) // 2
                assert torch.equal(cols[half:], cols[:half] + hidden)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_every_width_within_the_gate_has_a_plan(dtype):
    """The kernels take every width within the JAX package's 48 MiB of trunk
    weights (``kernel_takes``). The streamed plan's shared memory grows with
    the hidden width alone, and at the widest hidden width the gate takes at
    each depth from 0 to 12 DiT blocks it fits a CTA; ``kernel_plan`` keeps
    the resident plan where it fits (shared memory and piece table) and
    streams elsewhere."""
    for layers in range(13):
        hidden = 8
        while kernel_takes(8, hidden + 1, layers, dtype):
            hidden += 1
        padded = -(-hidden // 64) * 64
        smem = kernel_smem_bytes(8, padded, "v1", dtype, streamed=True)
        assert smem == sweep_smem_bytes(4096, padded, dtype, streamed=True) <= MAX_SMEM_BYTES
    # (latent, hidden, layers) -> (the kernel's hidden width, streamed)
    cases = {(32, 128, 6): (128, False), (32, 96, 2): (128, False),
             (32, 64, 44): (64, True)}  # 44 blocks: over MAX_PIECES pieces a step
    if dtype == torch.float32:
        cases[(64, 256, 6)] = (256, False)  # 230,464 B, the resident plan's widest
        cases[(64, 320, 1)] = (320, True)
    else:
        cases[(128, 512, 1)] = (512, True)  # the config's default width
    for (latent, hidden, layers), (kernel_hidden, streamed) in cases.items():
        packed = seeded_pack("v1", latent, hidden, layers, dtype)
        plan = kernel_plan(packed)
        assert (plan.hidden, plan.streamed) == (kernel_hidden, streamed)
        assert plan.smem == sweep_smem_bytes(latent, kernel_hidden, dtype, streamed)
        assert (packed.kernel.pieces.shape[1] > MAX_PIECES) == (layers == 44)


def test_bf16_shared_memory_plan():
    """At latent 64, hidden 256 (all three bf16 presets) the ring of
    STAGES x SLOT_BYTES with the activations fits a CTA's 232,448 B, the same
    for v1 and v2 (each holds one modulation slice at a time); hidden 512 does
    not fit; widths that are not a multiple of 64 are refused, in both weight
    types."""
    ring = STAGES * SLOT_BYTES
    v1 = kernel_smem_bytes(64, 256, "v1", torch.bfloat16)
    assert ring < v1 == kernel_smem_bytes(64, 256, "v2", torch.bfloat16) <= MAX_SMEM_BYTES
    # operands: latent (64 + 8), silu(cond) and x (256 + 8), MLP hidden (1024 + 8), in
    # bf16; the rank's slices of h (256 / 8), of the modulation (512 / 8) and of z
    # (64 / 8) in float32; the adaLN statistics, a float2 per rank and row
    c = KERNEL_CLUSTER
    activations = 16 * (2 * (72 + 2 * 264 + 1032) + 4 * (256 + 512 + 64) // c + 8 * c)
    assert v1 == ring + 64 + 8 * MAX_PIECES + 2 * 4 * 16 * (8 * CHUNK_TILES + 8) + activations
    assert v1 == sweep_smem_bytes(64, 256, torch.bfloat16) == 179_264
    assert kernel_smem_bytes(50, 64, "v2", torch.bfloat16) <= MAX_SMEM_BYTES
    assert kernel_smem_bytes(64, 256, "v1", torch.float32) == sweep_smem_bytes(64, 256)
    for variant in ("v1", "v2"):
        with pytest.raises(ValueError, match="shared memory"):
            kernel_smem_bytes(64, 512, variant, torch.bfloat16)
        with pytest.raises(ValueError, match="multiple of 64"):
            kernel_smem_bytes(8, 32, variant, torch.bfloat16)
        with pytest.raises(ValueError, match="multiple of 64"):
            kernel_smem_bytes(8, 36, variant, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        kernel_smem_bytes(128, 512, "v1", torch.float32)
    # a pack beyond the kernels' 48 MiB of trunk weights (float32, hidden 384, 6
    # blocks: 51.1 MB) carries no kernel layout; in bfloat16 the same width has one
    net = LatentScoreNetwork(8, OBS_DIM, hidden_dim=384, num_layers=6)
    assert packed_trunk_weights(net, "v1", torch.float32).kernel is None
    assert packed_trunk_weights(net, "v1", torch.bfloat16).kernel is not None
