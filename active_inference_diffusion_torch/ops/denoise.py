"""The fused K-step reverse-diffusion sweep: CUDA kernels and their plain version.

Counterpart of ``active_inference_diffusion_tpu/ops/denoise.py``: the v1
kernel ``_denoise_kernel`` (via ``fused_denoise_sweep``) and the v2 kernel
``_denoise_kernel_v2`` (via ``fused_denoise_sweep_v2``), each with float32
or bfloat16 matmul weights. One launch runs the whole belief sweep: for each
of K steps the DiT trunk (latent_proj, L adaLN blocks, final adaLN, out
head), the score clip and the p_sample update with in-kernel Gaussian noise.

- ``fused_denoise_sweep`` and ``fused_denoise_sweep_v2`` are the wrappers.
  For a CUDA tensor they launch the kernel of the packed weights' variant
  and type (``KERNELS``; all four from ``csrc/denoise_sweep_cluster.cu``,
  built on first use by ``ops/_build.py``) or raise; for a CPU tensor they
  run ``denoise_sweep_reference``. Launches are counted per kernel in
  ``LAUNCHES``. ``kernel_takes`` is the JAX package's ``fused_sweep_supported``
  rule (48 MiB of trunk weights): where it refuses a width, the caller runs
  ``plain_denoise_sweep`` on the card, counted apart in ``PLAIN_RUNS``.
- The kernels run each 16-row tile on a cluster of ``KERNEL_CLUSTER`` CTAs,
  each owning 1/``KERNEL_CLUSTER`` of every product's output columns, with
  tensor-core products; they read the weights from a second buffer of the
  pack in their own order (``kernel_layout``). Every width is padded with
  zero weights to a multiple of 8 x ``KERNEL_CLUSTER`` (64): the hidden
  width (the adaLN statistics count the real columns only), the latent and
  out_fc1's width. ``kernel_plan`` picks the resident plan (operand copies
  in shared memory) where it fits, else the streamed one (operand copies
  in global memory, one per cluster, read through L2).
- float32 weights: products accurate to float32 (3xTF32 on the card), no
  rounding anywhere.
- bfloat16 mode (``compute_dtype="bfloat16"``): the matmul weights (the
  ``*_w`` arrays) are stored in bfloat16, the activation operand of every
  product is rounded to bfloat16, products are exact and sums float32.
  Biases, LayerNorm, silu(cond), the score clip and the p_sample update stay
  float32. This is what the TPU kernels' ``x.astype(w.dtype)`` computes.
- The noise is a counter-based Philox4x32-10 followed by Box-Muller, keyed by
  (seed, global batch row) with counter (sweep step, latent column), so a
  draw depends neither on how the batch is tiled nor on the variant.
  ``philox_normal`` is the same generator in plain integer tensor ops: each
  kernel's stochastic sweep and the plain one agree to float tolerance.
  Against the JAX package (TPU PRNG bits) the stochastic sweep agrees in
  distribution only.
- Trunk weights are packed once per parameter set, variant and type into
  two contiguous buffers (``packed_trunk_weights``): the ``*_w`` arrays in
  the weight type, the ``*_b`` arrays in float32. The pack is cached on the
  score network and rebuilt when any of its parameters changes; inside a
  CUDA graph's capture it is rebuilt every time. The output multiplier
  stays on the device: the kernels read it through a pointer.

Numerics: LayerNorm eps 1e-6 and tanh-approximate GELU, as the Flax modules.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.schedules import DiffusionSchedule
from ..models.common import LN_EPS

# Batch rows per cluster; must equal TB in csrc/sweep_common.cuh.
ROWS_PER_CLUSTER = 16
# Dynamic shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232448
# The kernels' plan; each must equal its namesake in csrc/denoise_sweep_cluster.cu: CTAs
# per 16-row tile (CLUSTER), the bytes of one staged piece of weights (SLOT_BYTES), the
# ring's slots (STAGES), n-tiles of 8 columns per chunk (CHUNK_TILES), entries of a rank's
# piece table (MAX_PIECES), bytes of padding after each operand row (ROW_PAD).
KERNEL_CLUSTER = 8
SLOT_BYTES = 32768 + 512
STAGES = 3
CHUNK_TILES = 16
MAX_PIECES = 256
ROW_PAD = 16
_FRAG_BYTES = 32 * 8  # one B fragment of a warp: m16n8k16 bf16 or m16n8k8 tf32
# Elements of one mma k-step per weight type (32 bytes of an operand row).
K_STEP = {torch.bfloat16: 16, torch.float32: 8}

# Packed-buffer order per variant.
PACK_ORDER = {
    "v1": (
        "latent_proj_w", "latent_proj_b",
        "mod1_w", "mod1_b", "v_w", "v_b", "o_w", "o_b",
        "mod2_w", "mod2_b", "f1_w", "f1_b", "f2_w", "f2_b",
        "modf_w", "modf_b", "out1_w", "out1_b", "out2_w",
    ),
    "v2": (
        "latent_proj_w", "latent_proj_b", "mod_w", "mod_b", "vo_w", "vo_b",
        "f1_w", "f1_b", "f2_w", "f2_b", "out1_w", "out1_b", "out2_w",
    ),
}

# kernel name -> (variant, weight type, library, C function)
_LIBRARY = "denoise_sweep_cluster"
KERNELS = {
    "denoise_sweep_v1_f32": ("v1", torch.float32, _LIBRARY, "aid_denoise_sweep"),
    "denoise_sweep_v1_bf16": ("v1", torch.bfloat16, _LIBRARY, "aid_denoise_sweep_bf16"),
    "denoise_sweep_v2_f32": ("v2", torch.float32, _LIBRARY, "aid_denoise_sweep_v2"),
    "denoise_sweep_v2_bf16": ("v2", torch.bfloat16, _LIBRARY, "aid_denoise_sweep_v2_bf16"),
}
# Trunk weights the JAX package's fused sweep takes (``fused_sweep_supported``):
# the kernels take every width within it.
SWEEP_WEIGHT_BUDGET = 48 * 2**20
# Kernel launches, counted by the wrappers where they launch and nowhere else.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# Plain sweeps run on a CUDA device, counted per (variant, weight type) apart
# from LAUNCHES: for a width beyond ``kernel_takes`` (``plain_denoise_sweep``),
# and where a gradient or the trajectory is wanted (the core's
# ``scan_beliefs``).
PLAIN_RUNS: Dict[str, int] = {name: 0 for name in KERNELS}


def kernel_name(variant: str, dtype: torch.dtype) -> str:
    for name, (v, t, _, _) in KERNELS.items():
        if (v, t) == (variant, dtype):
            return name
    raise ValueError(f"no sweep kernel for variant {variant!r} with {dtype} weights")


# ---------------------------------------------------------------------------
# Coefficients and weights
# ---------------------------------------------------------------------------


def sweep_coefficients(
    schedule: DiffusionSchedule, num_steps: int, deterministic: bool
) -> torch.Tensor:
    """(K, 8) per-sweep-step coefficients, row 0 = first step (t = K-1):
    ``[s1, s2, c1, c2, sqrt(pv), noise_mask, 0, 0]``. A truncated sweep runs
    the schedule's tail t = K-1..0; there is no noise at t = 0."""
    device = schedule.betas.device
    t = torch.arange(num_steps - 1, -1, -1, device=device)
    noise_mask = ((t > 0) & (not deterministic)).to(torch.float32)
    cols = [
        schedule.sqrt_one_minus_alphas_cumprod[t],
        schedule.sqrt_recip_alphas[t],
        schedule.posterior_mean_coef1[t],
        schedule.posterior_mean_coef2[t],
        torch.sqrt(schedule.posterior_variance[t]),
        noise_mask,
        torch.zeros_like(noise_mask),
        torch.zeros_like(noise_mask),
    ]
    return torch.stack(cols, dim=1).to(torch.float32)


def extract_trunk_weights(score_net) -> Dict[str, torch.Tensor]:
    """Trunk weights of a ``LatentScoreNetwork`` in the JAX layout: matmul
    weights (in, out), per-block arrays stacked on a leading layer axis."""
    blocks = list(score_net.blocks)

    def w(linear):
        return linear.weight.detach().t()

    def b(linear):
        return linear.bias.detach()

    def stack(get):
        return torch.stack([get(blk) for blk in blocks])

    return {
        "latent_proj_w": w(score_net.latent_proj),
        "latent_proj_b": b(score_net.latent_proj),
        "mod1_w": stack(lambda k: w(k.norm1.adaLN_modulation)),
        "mod1_b": stack(lambda k: b(k.norm1.adaLN_modulation)),
        "v_w": stack(lambda k: w(k.attention.v_proj)),
        "v_b": stack(lambda k: b(k.attention.v_proj)),
        "o_w": stack(lambda k: w(k.attention.out_proj)),
        "o_b": stack(lambda k: b(k.attention.out_proj)),
        "mod2_w": stack(lambda k: w(k.norm2.adaLN_modulation)),
        "mod2_b": stack(lambda k: b(k.norm2.adaLN_modulation)),
        "f1_w": stack(lambda k: w(k.mlp_fc1)),
        "f1_b": stack(lambda k: b(k.mlp_fc1)),
        "f2_w": stack(lambda k: w(k.mlp_fc2)),
        "f2_b": stack(lambda k: b(k.mlp_fc2)),
        "modf_w": w(score_net.norm_final.adaLN_modulation),
        "modf_b": b(score_net.norm_final.adaLN_modulation),
        "out1_w": w(score_net.out_fc1),
        "out1_b": b(score_net.out_fc1),
        "out2_w": w(score_net.out_fc2),
        "output_multiplier": score_net.output_multiplier.detach(),
    }


def extract_trunk_weights_v2(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """v1 weights (``extract_trunk_weights``) restructured for the v2 kernel,
    as ``extract_trunk_weights_v2`` of the JAX package: ``vo_w = Wv @ Wo``
    and ``vo_b = bv @ Wo + bo`` per block, and all 2L+1 modulation products
    side by side, ``mod_w`` (H, L*4H + 2H) = [mod1_0 | mod2_0 | ... |
    mod_final]. The products are composed in float64 on the weights' own
    device and rounded to float32 once, so no TF32 enters whatever the
    card's matmul flags say, and no weight leaves the card."""
    num_layers = w["v_w"].shape[0]

    def compose(a, b):
        return torch.matmul(a.double(), b.double()).float()

    mods, bmods = [], []
    for l in range(num_layers):
        mods += [w["mod1_w"][l], w["mod2_w"][l]]
        bmods += [w["mod1_b"][l], w["mod2_b"][l]]
    mods.append(w["modf_w"])
    bmods.append(w["modf_b"])
    return {
        "latent_proj_w": w["latent_proj_w"],
        "latent_proj_b": w["latent_proj_b"],
        "mod_w": torch.cat(mods, dim=1),
        "mod_b": torch.cat(bmods, dim=0),
        "vo_w": compose(w["v_w"], w["o_w"]),
        "vo_b": compose(w["v_b"][:, None, :], w["o_w"])[:, 0] + w["o_b"],
        "f1_w": w["f1_w"],
        "f1_b": w["f1_b"],
        "f2_w": w["f2_w"],
        "f2_b": w["f2_b"],
        "out1_w": w["out1_w"],
        "out1_b": w["out1_b"],
        "out2_w": w["out2_w"],
        "output_multiplier": w["output_multiplier"],
    }


class KernelLayout(NamedTuple):
    """The kernels' copy of a pack (``kernel_layout``): ``weights`` (words of
    the pack's weight type) holds, per product, per cluster rank, per chunk of at
    most ``CHUNK_TILES`` n-tiles and per piece of k-steps, the rank's columns
    in mma.sync B-fragment order; a chunk's first piece starts with the
    chunk's float32 biases. ``pieces`` (int32, ``(KERNEL_CLUSTER, P, 2)``)
    holds each piece's (offset in 16-byte units, bytes) for one sweep step,
    per rank."""

    weights: torch.Tensor
    pieces: torch.Tensor


class PackedTrunk(NamedTuple):
    """Trunk weights of one sweep variant in two contiguous buffers:
    ``weights`` holds the ``*_w`` arrays in the weight type (float32 or
    bfloat16), ``biases`` the ``*_b`` arrays in float32.

    ``offsets[name] = (element offset in its buffer, shape)``; each entry
    starts on a 16-byte boundary. ``output_multiplier`` is a 0-d float32
    tensor on the weights' device that views the score network's parameter
    (not a copy), so the sweep reads its value when it runs: no host read at
    pack time, and a captured sweep follows the trained value.
    A pack whose widths the kernels take also carries their
    ``KernelLayout`` in ``kernel``."""

    variant: str
    weights: torch.Tensor
    biases: torch.Tensor
    offsets: Dict[str, Tuple[int, Tuple[int, ...]]]
    latent_dim: int
    hidden_dim: int
    num_layers: int
    output_multiplier: torch.Tensor
    kernel: Optional[KernelLayout] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.weights.dtype

    def views(self) -> Dict[str, torch.Tensor]:
        return {
            name: (self.weights if name.endswith("_w") else self.biases)[
                off : off + math.prod(shape)
            ].view(shape)
            for name, (off, shape) in self.offsets.items()
        }


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def kernel_products(packed: PackedTrunk) -> List[Tuple[torch.Tensor, Optional[torch.Tensor], bool]]:
    """The products of one sweep step in the kernels' order, as
    (weight (in, out), bias or None, is a modulation): latent_proj; per
    layer the first modulation, v_proj and out_proj (v1) or the composed vo
    (v2), the second modulation, fc1, fc2; the final modulation, out_fc1,
    out_fc2. v2's modulations are its 2L+1 sites of ``mod_w``, taken in
    turn. A modulation's columns are [scale | shift]."""
    v = packed.views()
    h2 = 2 * packed.hidden_dim
    if packed.variant == "v1":
        mods = [(v[f"mod{k}_w"][l], v[f"mod{k}_b"][l], True)
                for l in range(packed.num_layers) for k in (1, 2)]
        mods.append((v["modf_w"], v["modf_b"], True))
    else:
        mods = [(v["mod_w"][:, j * h2 : (j + 1) * h2], v["mod_b"][j * h2 : (j + 1) * h2], True)
                for j in range(2 * packed.num_layers + 1)]
    products = [(v["latent_proj_w"], v["latent_proj_b"], False)]
    for l in range(packed.num_layers):
        products.append(mods[2 * l])
        if packed.variant == "v1":
            products += [(v["v_w"][l], v["v_b"][l], False), (v["o_w"][l], v["o_b"][l], False)]
        else:
            products.append((v["vo_w"][l], v["vo_b"][l], False))
        products += [mods[2 * l + 1], (v["f1_w"][l], v["f1_b"][l], False),
                     (v["f2_w"][l], v["f2_b"][l], False)]
    return products + [mods[-1], (v["out1_w"], v["out1_b"], False), (v["out2_w"], None, False)]


def kernel_shapes(packed: PackedTrunk) -> List[Tuple[int, int]]:
    """The (in, out) shape the kernels see of each product of
    ``kernel_products``, in its order: every width padded to a multiple of
    8 x ``KERNEL_CLUSTER``, the hidden one to ``hp`` (so the MLP's to 4
    ``hp``, a modulation's to 2 ``hp``), out_fc1's to that multiple of
    ``hp / 2``."""
    c8 = 8 * KERNEL_CLUSTER
    hp, dp = _round_up(packed.hidden_dim, c8), _round_up(packed.latent_dim, c8)
    np1 = _round_up(hp // 2, c8)
    attn = [(hp, hp), (hp, hp)] if packed.variant == "v1" else [(hp, hp)]
    block = [(hp, 2 * hp), *attn, (hp, 2 * hp), (hp, 4 * hp), (4 * hp, hp)]
    return [(dp, hp), *block * packed.num_layers, (hp, 2 * hp), (hp, np1), (np1, dp)]


def embed_product(w: torch.Tensor, b: Optional[torch.Tensor], modulation: bool,
                  shape: Tuple[int, int], fill) -> Tuple[torch.Tensor, torch.Tensor]:
    """A product's (in, out) weight and its bias placed in the kernels'
    padded ``shape``, ``fill`` elsewhere (no bias: all ``fill``): a plain
    product at the top left, a modulation's scale and shift halves each at
    the start of its half."""
    wp = torch.full(shape, fill, dtype=w.dtype)
    bp = torch.full(shape[1:], fill, dtype=w.dtype)
    k, n = w.shape
    halves = ((0, 0, n // 2), (n // 2, shape[1] // 2, n // 2)) if modulation else ((0, 0, n),)
    for src, dst, width in halves:
        wp[:k, dst : dst + width] = w[:, src : src + width]
        if b is not None:
            bp[dst : dst + width] = b[src : src + width]
    return wp, bp


def rank_columns(out: int, modulation: bool, rank: int) -> torch.Tensor:
    """Output columns of one product that cluster rank ``rank`` computes, in
    its slice's order, for the product's padded width ``out``
    (``kernel_shapes``; a width that is not yet a multiple of 8 x
    ``KERNEL_CLUSTER`` is rounded up). A plain product's columns are split
    in contiguous slices; a modulation's rank takes the scale and the shift
    columns of its own h-columns."""
    c = KERNEL_CLUSTER
    if modulation:
        hc = out // 2 // c
        own = torch.arange(rank * hc, (rank + 1) * hc)
        return torch.cat([own, out // 2 + own])
    width = _round_up(out, 8 * c) // c
    return torch.arange(rank * width, (rank + 1) * width)


def _pieces(n_tiles: int, k_steps: int) -> int:
    """Pieces a chunk's k-steps are cut into: the fewest equal ones whose
    fragments fit a slot beside the largest bias head."""
    budget = SLOT_BYTES - 32 * CHUNK_TILES
    return next(p for p in range(1, k_steps + 1)
                if k_steps % p == 0 and n_tiles * (k_steps // p) * _FRAG_BYTES <= budget)


# Each pack shape's layout as a gather order (``_layout_order``), per device.
_LAYOUT_ORDERS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def kernel_layout(packed: PackedTrunk) -> KernelLayout:
    """The kernels' weight order for ``packed`` (see ``KernelLayout``): one
    gather from the pack's two buffers, in an order worked out once per
    pack shape and device (``_layout_order``), since the weights change at
    every train step and the order does not."""
    dev = packed.weights.device
    key = (packed.variant, packed.dtype, packed.latent_dim, packed.hidden_dim,
           packed.num_layers, dev)
    if key not in _LAYOUT_ORDERS:
        order, pieces = _layout_order(packed)
        _LAYOUT_ORDERS[key] = (order.to(dev), pieces.to(dev))
    order, pieces = _LAYOUT_ORDERS[key]
    source = torch.cat([packed.weights, packed.biases.view(packed.dtype),
                        packed.weights.new_zeros(1)])
    return KernelLayout(weights=source[order], pieces=pieces)


def _layout_order(packed: PackedTrunk) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, pieces) of the kernels' layout of ``packed``'s shapes:
    element i of the layout is element ``order[i]`` of [the pack's weights,
    its float32 biases read as words of the weight type, one zero].

    B fragment of mma.sync, 8 contiguous bytes a lane (lane = 4 g + t):
    bfloat16 (m16n8k16, a k-step of 16) W[k0 + 2t + {0, 1, 8, 9}, n0 + g];
    float32 (m16n8k8 tf32, a k-step of 8) W[k0 + t + {0, 4}, n0 + g]. A
    piece is [n-tile][k-step][lane][fragment], after the chunk's 8 x n-tiles
    float32 biases in its first piece. Each product is padded to its
    ``kernel_shapes`` shape with zeros (``embed_product``), as the kernels'
    operand copies are."""
    c = KERNEL_CLUSTER
    dtype = packed.dtype
    size = torch.finfo(dtype).bits // 8
    k_step, per_frag = K_STEP[dtype], _FRAG_BYTES // size
    n_weights = packed.weights.numel()
    words = 4 // size  # words of the weight type a float32 bias takes
    zero = n_weights + words * packed.biases.numel()
    # the pack with each element's own index in place of its value
    index = packed._replace(weights=torch.arange(n_weights),
                            biases=torch.arange(packed.biases.numel()))
    parts: List[torch.Tensor] = []
    table: List[List[Tuple[int, int]]] = [[] for _ in range(c)]
    cursor = 0
    for (w, b, modulation), shape in zip(kernel_products(index), kernel_shapes(index)):
        wp, _ = embed_product(w, None, modulation, shape, zero)
        _, bp = embed_product(w, b, modulation, shape, -1)
        kp = shape[0]
        for r in range(c):
            cols = rank_columns(shape[1], modulation, r)
            wr = wp[:, cols]
            br = bp[cols]
            n_tiles, k_steps = wr.shape[1] // 8, kp // k_step
            for n0 in range(0, n_tiles, CHUNK_TILES):
                ntc = min(CHUNK_TILES, n_tiles - n0)
                sub = wr[:, 8 * n0 : 8 * (n0 + ntc)]
                if dtype == torch.bfloat16:
                    # [k = 16 ks + 8 jhi + 2 t + jlo, n = 8 nt + g] -> [nt, ks, g, t, jhi, jlo]
                    frag = sub.reshape(k_steps, 2, 4, 2, ntc, 8).permute(4, 0, 5, 2, 1, 3)
                else:
                    # [k = 8 ks + 4 j + t, n = 8 nt + g] -> [nt, ks, g, t, j]
                    frag = sub.reshape(k_steps, 2, 4, ntc, 8).permute(3, 0, 4, 2, 1)
                pieces = _pieces(ntc, k_steps)
                frag = frag.reshape(ntc, pieces, k_steps // pieces, per_frag).transpose(0, 1)
                for q in range(pieces):
                    part = frag[q].reshape(-1)
                    if q == 0:
                        bias = br[8 * n0 : 8 * (n0 + ntc), None]
                        bias = torch.where(bias < 0, zero,
                                           n_weights + words * bias + torch.arange(words))
                        part = torch.cat([bias.reshape(-1), part])
                    table[r].append((cursor * size // 16, part.numel() * size))
                    parts.append(part)
                    cursor += part.numel()
    return torch.cat(parts), torch.tensor(table, dtype=torch.int32)


def pack_trunk_weights(
    weights: Dict[str, torch.Tensor], variant: str = "v1", dtype: torch.dtype = torch.float32
) -> PackedTrunk:
    """Pack ``extract_trunk_weights`` output (v1) or its
    ``extract_trunk_weights_v2`` form (v2) into a ``PackedTrunk`` whose
    matmul weights are cast to ``dtype``."""
    offsets: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
    parts: Dict[bool, List[torch.Tensor]] = {True: [], False: []}
    cursor = {True: 0, False: 0}
    for name in PACK_ORDER[variant]:
        is_w = name.endswith("_w")
        t = weights[name].to(dtype if is_w else torch.float32).reshape(-1)
        offsets[name] = (cursor[is_w], tuple(weights[name].shape))
        pad = -t.numel() % (16 // t.element_size())
        parts[is_w].append(t)
        if pad:
            parts[is_w].append(t.new_zeros(pad))
        cursor[is_w] += t.numel() + pad
    lp = weights["latent_proj_w"]
    packed = PackedTrunk(
        variant=variant,
        weights=torch.cat(parts[True]).contiguous(),
        biases=torch.cat(parts[False]).contiguous(),
        offsets=offsets,
        latent_dim=lp.shape[0],
        hidden_dim=lp.shape[1],
        num_layers=weights["f1_w"].shape[0],
        output_multiplier=torch.as_tensor(
            weights["output_multiplier"], dtype=torch.float32, device=lp.device
        ).reshape(-1)[0],
    )
    if kernel_takes(packed.latent_dim, packed.hidden_dim, packed.num_layers, dtype):
        packed = packed._replace(kernel=kernel_layout(packed))
    return packed


def packed_trunk_weights(
    score_net, variant: str = "v1", dtype: torch.dtype = torch.float32
) -> PackedTrunk:
    """The score network's ``PackedTrunk`` for one variant and weight type,
    cached on the module per (variant, type). The cache key holds every
    parameter's storage pointer and version counter, so any load or
    in-place update of the weights rebuilds the pack.

    While the current stream captures a CUDA graph the pack is always
    rebuilt and never cached: the gather then belongs to the graph, which
    repacks the live weights at every replay, and no pack in the graph's
    memory pool is handed to a later eager call. Replays update the weights
    without moving their version counters, so whoever replays such a graph
    calls ``forget_packed_trunks`` afterwards."""
    capturing = score_net.output_multiplier.is_cuda and torch.cuda.is_current_stream_capturing()
    key = tuple((p.data_ptr(), p._version) for p in score_net.parameters())
    cache = score_net.__dict__.setdefault("_packed_trunks", {})
    cached = cache.get((variant, dtype))
    if cached is not None and cached[0] == key and not capturing:
        return cached[1]
    with torch.no_grad():
        w = extract_trunk_weights(score_net)
        if variant == "v2":
            w = extract_trunk_weights_v2(w)
        packed = pack_trunk_weights(w, variant, dtype)
    if not capturing:
        cache[(variant, dtype)] = (key, packed)
    return packed


def forget_packed_trunks(score_net) -> None:
    """Drop the score network's cached packs, so the next sweep repacks the
    weights it finds."""
    score_net.__dict__.pop("_packed_trunks", None)


def trunk_weight_bytes(hidden_dim: int, latent_dim: int, num_layers: int,
                       bytes_per_param: int = 4) -> int:
    """Bytes of the v1 trunk's matmul weights, as the JAX package's
    ``trunk_weight_bytes`` counts them."""
    h, d, l = hidden_dim, latent_dim, num_layers
    per_block = h * 2 * h + h * h + h * h + h * 2 * h + h * 4 * h + 4 * h * h
    total = l * per_block + d * h + h * 2 * h + h * (h // 2) + (h // 2) * d
    return bytes_per_param * total


def kernel_takes(latent_dim: int, hidden_dim: int, num_layers: int, dtype: torch.dtype) -> bool:
    """Whether the sweep kernels take this width in this weight type: the
    JAX package's ``fused_sweep_supported`` rule, at most
    ``SWEEP_WEIGHT_BUDGET`` bytes of trunk weights. Every width within it
    has a plan (``kernel_plan``); beyond it the caller runs the plain
    sweep."""
    size = torch.finfo(dtype).bits // 8
    return trunk_weight_bytes(hidden_dim, latent_dim, num_layers, size) <= SWEEP_WEIGHT_BUDGET


def sweep_smem_bytes(latent_dim: int, hidden_dim: int, dtype: torch.dtype = torch.float32,
                     streamed: bool = False) -> int:
    """Dynamic shared memory of one CTA of a kernel's cluster, either variant,
    at the kernel's (padded) widths. Both plans hold the weight ring, its
    barriers, two buffers of split-K partials, the rank's float32 slices of
    the residual stream and of one modulation, and the adaLN statistics (a
    float2 per rank and row). The resident plan adds the piece table and
    the operand copies in the weight type (rows padded by ``ROW_PAD``
    bytes) of the whole latent (padded to 8 x ``KERNEL_CLUSTER``),
    silu(cond), the adaLN output and the MLP hidden, and the rank's float32
    slice of z; the streamed plan keeps those in global memory. Mirrors
    ``make_plan`` in csrc/denoise_sweep_cluster.cu."""
    tb, c = ROWS_PER_CLUSTER, KERNEL_CLUSTER
    fixed = (STAGES * SLOT_BYTES + 64 + 2 * 4 * tb * (8 * CHUNK_TILES + 8)
             + 4 * tb * 3 * hidden_dim // c + 8 * c * tb)
    if streamed:
        return fixed
    size = torch.finfo(dtype).bits // 8
    d_pad = _round_up(latent_dim, 8 * c)
    out1 = _round_up(hidden_dim // 2, 8 * c)
    operands = (d_pad, hidden_dim, hidden_dim, max(4 * hidden_dim, out1))
    return (fixed + 8 * MAX_PIECES + sum(tb * (size * width + ROW_PAD) for width in operands)
            + 4 * tb * d_pad // c)


def kernel_smem_bytes(latent_dim: int, hidden_dim: int, variant: str, dtype: torch.dtype,
                      streamed: bool = False) -> int:
    """The shared memory a sweep kernel's CTA is launched with at the
    kernel's widths, in one plan; raises ValueError where that plan cannot
    take them: hidden_dim a multiple of 8 x ``KERNEL_CLUSTER`` (64; a
    model's hidden width is padded to it), the plan within
    ``MAX_SMEM_BYTES``. The latent and out_fc1's width are padded to that
    multiple."""
    name = kernel_name(variant, dtype)
    step = 8 * KERNEL_CLUSTER
    if hidden_dim % step:
        raise ValueError(f"{name} takes hidden_dim a multiple of {step} (8 columns x its "
                         f"cluster of {KERNEL_CLUSTER} CTAs), got {hidden_dim}")
    smem = sweep_smem_bytes(latent_dim, hidden_dim, dtype, streamed)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"{name} at latent_dim={latent_dim}, hidden_dim={hidden_dim} needs {smem} bytes "
            f"of shared memory per block in its {'streamed' if streamed else 'resident'} "
            f"plan; the kernel allows {MAX_SMEM_BYTES}"
        )
    return smem


class KernelPlan(NamedTuple):
    """How a kernel runs one width: the kernel's hidden width (the model's
    padded to 8 x ``KERNEL_CLUSTER``), whether the operand copies are
    streamed from global memory, and the shared memory of a CTA."""

    hidden: int
    streamed: bool
    smem: int


def kernel_plan(packed: PackedTrunk) -> KernelPlan:
    """The plan of a pack the kernels take: resident where its shared memory
    and piece table fit, else streamed; raises ValueError for a pack beyond
    ``kernel_takes`` or without a kernel layout."""
    name = kernel_name(packed.variant, packed.dtype)
    if packed.kernel is None:
        raise ValueError(f"{name}: the pack (latent {packed.latent_dim}, hidden "
                         f"{packed.hidden_dim}, {packed.num_layers} layers) has no kernel layout: "
                         f"its trunk is over the kernels' {SWEEP_WEIGHT_BUDGET} bytes")
    hidden = _round_up(packed.hidden_dim, 8 * KERNEL_CLUSTER)
    resident = sweep_smem_bytes(packed.latent_dim, hidden, packed.dtype)
    if resident <= MAX_SMEM_BYTES and packed.kernel.pieces.shape[1] <= MAX_PIECES:
        return KernelPlan(hidden, False, resident)
    smem = kernel_smem_bytes(packed.latent_dim, hidden, packed.variant, packed.dtype, True)
    return KernelPlan(hidden, True, smem)


# ---------------------------------------------------------------------------
# Noise: Philox4x32-10 + Box-Muller
# ---------------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """High and low 32 bits of the 64-bit product a * b, for a 32-bit
    constant a and int64 tensors b holding 32-bit values; split in 16-bit
    halves so no intermediate exceeds 2**49."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK32


def philox4x32(
    counter: Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Philox4x32 with 10 rounds (Salmon et al., SC'11) on int64 tensors
    holding uint32 values; the arguments broadcast."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_normal(
    seed: torch.Tensor, rows: torch.Tensor, step: int, cols: torch.Tensor
) -> torch.Tensor:
    """Standard normals, one per (row, col), for one sweep step; the draw of
    the kernels' ``philox_normal``. Key (seed, row), counter (step, col, 0,
    0); u1 = (r0 >> 8 + 1) / 2**24 in (0, 1], u2 = (r1 >> 8) / 2**24 in
    [0, 1), z = sqrt(-2 ln u1) cos(2 pi u2)."""
    k0 = seed.to(torch.int64) & _MASK32
    k1 = rows.to(torch.int64)
    c0 = torch.full_like(cols, step, dtype=torch.int64)
    c1 = cols.to(torch.int64)
    zero = torch.zeros_like(c1)
    r0, r1, _, _ = philox4x32((c0, c1, zero, zero), (k0, k1))
    u1 = ((r0 >> 8) + 1).to(torch.float32) * (1.0 / (1 << 24))
    u2 = (r1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)


# ---------------------------------------------------------------------------
# The sweep
# ---------------------------------------------------------------------------


def denoise_sweep_reference(
    schedule: DiffusionSchedule,
    weights: PackedTrunk,
    z0: torch.Tensor,
    obs_emb: torch.Tensor,
    t_embs: torch.Tensor,
    seed: torch.Tensor,
    num_steps: int,
    num_layers: int,
    deterministic: bool = False,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernels, on any device, for either
    variant and weight type of ``weights``. ``noise`` (K, B, D), when given,
    replaces the Philox draw (for tests that feed both packages the same
    numbers). With bfloat16 weights each product's activation operand is
    rounded to bfloat16 and the product taken in float32 (exact); on the
    card that needs TF32 off, as the callers set it."""
    views = weights.views()
    w = {name: v.float() for name, v in views.items()}
    rounded = weights.dtype != torch.float32
    h_dim = weights.hidden_dim
    coeffs = sweep_coefficients(schedule, num_steps, deterministic)
    mult = weights.output_multiplier
    rows = torch.arange(z0.shape[0], device=z0.device)[:, None]
    cols = torch.arange(z0.shape[1], device=z0.device)[None, :]

    def mm(x, name, l=None, bias=None):
        if rounded:
            x = x.to(weights.dtype).float()
        y = x @ (w[name] if l is None else w[name][l])
        if bias is not None:
            y = y + (w[bias] if l is None else w[bias][l])
        return y

    def adaln(x, mod):
        return F.layer_norm(x, (h_dim,), eps=LN_EPS) * (1.0 + mod[:, :h_dim]) + mod[:, h_dim:]

    def trunk_v1(z, sc):
        h = mm(z, "latent_proj_w", bias="latent_proj_b")
        for l in range(num_layers):
            x1 = adaln(h, mm(sc, "mod1_w", l, "mod1_b"))
            h = h + mm(mm(x1, "v_w", l, "v_b"), "o_w", l, "o_b")
            x2 = adaln(h, mm(sc, "mod2_w", l, "mod2_b"))
            h = h + mm(F.gelu(mm(x2, "f1_w", l, "f1_b"), approximate="tanh"), "f2_w", l, "f2_b")
        return adaln(h, mm(sc, "modf_w", bias="modf_b"))

    def trunk_v2(z, sc):
        mods = mm(sc, "mod_w", bias="mod_b")
        h = mm(z, "latent_proj_w", bias="latent_proj_b")
        for l in range(num_layers):
            base = 4 * h_dim * l
            h = h + mm(adaln(h, mods[:, base : base + 2 * h_dim]), "vo_w", l, "vo_b")
            x2 = adaln(h, mods[:, base + 2 * h_dim : base + 4 * h_dim])
            h = h + mm(F.gelu(mm(x2, "f1_w", l, "f1_b"), approximate="tanh"), "f2_w", l, "f2_b")
        return adaln(h, mods[:, 4 * h_dim * num_layers :])

    trunk = trunk_v1 if weights.variant == "v1" else trunk_v2
    z = z0
    for i in range(num_steps):
        sc = F.silu(obs_emb + t_embs[i][None, :])
        o1 = F.silu(mm(trunk(z, sc), "out1_w", bias="out1_b"))
        score = torch.clamp(mm(o1, "out2_w"), -10.0, 10.0) * mult

        s1, s2, c1, c2, sd, mask = coeffs[i, :6]
        pz0 = (z + s1 * score) * s2
        z_next = c1 * pz0 + c2 * z
        if not deterministic and i < num_steps - 1:  # noise_mask is 1 here
            eps = noise[i] if noise is not None else philox_normal(seed, rows, i, cols)
            z_next = z_next + mask * sd * eps
        z = z_next
    return z


def _check_args(schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers):
    b, d = z0.shape
    h = obs_emb.shape[-1]
    device = z0.device
    tensors = {
        "z0": z0, "obs_emb": obs_emb, "t_embs": t_embs,
        "weights.biases": weights.biases, "schedule": schedule.betas,
    }
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, z0 on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if weights.weights.device != device:
        raise ValueError(f"weights.weights is on {weights.weights.device}, z0 on {device}")
    if weights.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul weights must be float32 or bfloat16, got {weights.dtype}")
    if seed.device != device or seed.dtype != torch.int64 or seed.dim() != 0:
        raise TypeError("seed must be a 0-d int64 tensor on z0's device")
    if obs_emb.shape != (b, h) or t_embs.shape != (num_steps, h):
        raise ValueError(
            f"shapes z0 {tuple(z0.shape)}, obs_emb {tuple(obs_emb.shape)}, "
            f"t_embs {tuple(t_embs.shape)} do not fit num_steps={num_steps}"
        )
    if (weights.latent_dim, weights.hidden_dim, weights.num_layers) != (d, h, num_layers):
        raise ValueError("packed weights do not match (latent_dim, hidden_dim, num_layers)")
    if not 0 < num_steps <= schedule.num_steps:
        raise ValueError(f"num_steps={num_steps} outside 1..{schedule.num_steps}")
    if weights.kernel is not None and weights.kernel.weights.device != device:
        raise ValueError(f"weights.kernel is on {weights.kernel.weights.device}, z0 on {device}")
    mult = weights.output_multiplier
    if not (isinstance(mult, torch.Tensor) and mult.device == device
            and mult.dtype == torch.float32 and mult.dim() == 0):
        raise TypeError("weights.output_multiplier must be a 0-d float32 tensor on z0's device")


def _sweep(variant, schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers,
           deterministic):
    """Check, then run the plain version (CPU) or launch the kernel of
    (variant, weight type) (CUDA) and count the launch."""
    if weights.variant != variant:
        raise ValueError(f"the {variant} sweep got weights packed for {weights.variant}")
    _check_args(schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers)
    if z0.device.type == "cpu":
        return denoise_sweep_reference(
            schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers,
            deterministic,
        )
    if z0.device.type != "cuda":
        raise NotImplementedError(f"no denoise sweep for device {z0.device}")

    name = kernel_name(variant, weights.dtype)
    _, _, library, function = KERNELS[name]
    b, d = z0.shape
    plan = kernel_plan(weights)
    for arg, t in (("z0", z0), ("obs_emb", obs_emb), ("t_embs", t_embs)):
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    layout = weights.kernel

    from ._build import load_library

    lib = load_library(library)
    coeffs = sweep_coefficients(schedule, num_steps, deterministic).contiguous()
    out = torch.empty_like(z0)
    arena = None
    if plan.streamed:  # one arena per cluster of 16 rows
        per_cluster = lib.aid_sweep_arena_bytes(int(weights.dtype == torch.bfloat16), d,
                                                plan.hidden)
        clusters = -(-b // ROWS_PER_CLUSTER)
        arena = torch.empty(clusters * per_cluster, dtype=torch.uint8, device=z0.device)
    with torch.cuda.device(z0.device):
        stream = torch.cuda.current_stream(z0.device).cuda_stream
        _check_clusters(lib, name, variant, weights.dtype, plan, z0.device)
        err = getattr(lib, function)(
            z0.data_ptr(), obs_emb.data_ptr(), t_embs.data_ptr(), coeffs.data_ptr(),
            layout.weights.data_ptr(), layout.pieces.data_ptr(), seed.data_ptr(), out.data_ptr(),
            None if arena is None else arena.data_ptr(),
            b, d, plan.hidden, weights.hidden_dim, num_layers, num_steps, layout.pieces.shape[1],
            weights.output_multiplier.data_ptr(), 0 if deterministic else 1, int(plan.streamed),
            plan.smem,
            stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.aid_cuda_error_string(err).decode()} ({err})"
        )
    LAUNCHES[name] += 1
    return out


# (kernel, shared memory, device) whose cluster the card was found to hold.
_CLUSTERS_CHECKED: set = set()


def _check_clusters(lib, name, variant, dtype, plan: KernelPlan, device) -> None:
    """Before the first launch of a plan: raise unless the library was built
    for ``KERNEL_CLUSTER`` and the card can hold at least one cluster of it
    with the plan's shared memory per CTA (cudaOccupancyMaxActiveClusters).
    Never falls back to another kernel, plan or cluster size."""
    key = (name, plan.streamed, plan.smem, device)
    if key in _CLUSTERS_CHECKED:
        return
    built = lib.aid_sweep_cluster_size()
    if built != KERNEL_CLUSTER:
        raise RuntimeError(f"{name} was built for clusters of {built}, not {KERNEL_CLUSTER}")
    count = max_active_clusters(lib, variant, dtype, plan.smem, plan.streamed)
    if count < 1:
        raise RuntimeError(
            f"{name}: the card holds no cluster of {KERNEL_CLUSTER} CTAs with {plan.smem} "
            "bytes of shared memory each"
        )
    _CLUSTERS_CHECKED.add(key)


def max_active_clusters(lib, variant: str, dtype: torch.dtype, smem: int,
                        streamed: bool = False) -> int:
    """Clusters of the kernel of (variant, weight type, plan) with ``smem``
    bytes per CTA that the current card holds at once; raises if the query
    fails."""
    count = ctypes.c_int(0)
    err = lib.aid_sweep_max_clusters(1 if variant == "v1" else 2, int(dtype == torch.bfloat16),
                                     int(streamed), smem, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"{lib.aid_cuda_error_string(err).decode()} ({err})")
    return count.value


def plain_denoise_sweep(
    schedule: DiffusionSchedule,
    weights: PackedTrunk,
    z0: torch.Tensor,
    obs_emb: torch.Tensor,
    t_embs: torch.Tensor,
    seed: torch.Tensor,
    num_steps: int,
    num_layers: int,
    deterministic: bool = False,
) -> torch.Tensor:
    """The sweep as ``denoise_sweep_reference`` on the tensors' own device,
    for a width beyond ``kernel_takes``. On a CUDA device the run is
    counted in ``PLAIN_RUNS``; it never stands in for a kernel that
    failed."""
    _check_args(schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers)
    out = denoise_sweep_reference(
        schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers, deterministic
    )
    count_plain_run(weights.variant, weights.dtype, z0.device)
    return out


def count_plain_run(variant: str, dtype: torch.dtype, device: torch.device) -> None:
    """Counts one plain sweep of (variant, weight type) in ``PLAIN_RUNS``
    where it ran on a CUDA device."""
    if device.type == "cuda":
        PLAIN_RUNS[kernel_name(variant, dtype)] += 1


def fused_denoise_sweep(
    schedule: DiffusionSchedule,
    weights: PackedTrunk,
    z0: torch.Tensor,  # (B, D)
    obs_emb: torch.Tensor,  # (B, H)
    t_embs: torch.Tensor,  # (K, H), row i = timestep K-1-i
    seed: torch.Tensor,  # 0-d int64
    num_steps: int,
    num_layers: int,
    deterministic: bool = False,
) -> torch.Tensor:
    """Run the full K-step denoise with v1 weights (float32 or bfloat16);
    returns z_0 (B, D) float32.

    A CUDA tensor launches the v1 kernel of the weights' type (one launch,
    counted in ``LAUNCHES``) or raises; a CPU tensor runs
    ``denoise_sweep_reference``."""
    return _sweep("v1", schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers,
                  deterministic)


def fused_denoise_sweep_v2(
    schedule: DiffusionSchedule,
    weights: PackedTrunk,
    z0: torch.Tensor,
    obs_emb: torch.Tensor,
    t_embs: torch.Tensor,
    seed: torch.Tensor,
    num_steps: int,
    num_layers: int,
    deterministic: bool = False,
) -> torch.Tensor:
    """The v2 sweep (weights packed for ``"v2"``): the same semantics as
    ``fused_denoise_sweep``, with v_proj@out_proj and the modulation
    products combined algebraically. A CUDA tensor launches the v2 kernel of
    the weights' type or raises; it never runs v1."""
    return _sweep("v2", schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers,
                  deterministic)
