"""The fused K-step reverse-diffusion sweep: a CUDA kernel and its plain version.

Counterpart of ``active_inference_diffusion_tpu/ops/denoise.py`` (v1 kernel,
``_denoise_kernel`` via ``fused_denoise_sweep``). One launch runs the whole
belief sweep: for each of K steps the DiT trunk (latent_proj, L adaLN blocks,
final adaLN, out head), the score clip and the p_sample update with in-kernel
Gaussian noise.

- ``fused_denoise_sweep`` is the wrapper. For a CUDA tensor it launches
  ``csrc/denoise_sweep.cu`` (built on first use by ``ops/_build.py``) or
  raises; for a CPU tensor it runs ``denoise_sweep_reference``. It counts
  its kernel launches in ``fused_denoise_sweep.launches``.
- The noise is a counter-based Philox4x32-10 followed by Box-Muller, keyed by
  (seed, global batch row) with counter (sweep step, latent column), so a
  draw does not depend on how the batch is tiled. ``philox_normal`` is the
  same generator in plain integer tensor ops: the kernel's stochastic sweep
  and the plain one agree to float tolerance. Against the JAX package (TPU
  PRNG bits) the stochastic sweep agrees in distribution only.
- Trunk weights are packed once per parameter set into one contiguous
  float32 buffer (``packed_trunk_weights``), cached on the score network
  and rebuilt when any of its parameters changes.

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

# Batch rows per thread block; must equal TB in csrc/denoise_sweep.cu.
ROWS_PER_BLOCK = 16
# Dynamic shared memory one block may use on an H100 (227 KB).
MAX_SMEM_BYTES = 232448

# Packed-buffer order; csrc/denoise_sweep.cu's TrunkOffsets lists the same
# fields in the same order.
PACK_ORDER = (
    "latent_proj_w", "latent_proj_b",
    "mod1_w", "mod1_b", "v_w", "v_b", "o_w", "o_b",
    "mod2_w", "mod2_b", "f1_w", "f1_b", "f2_w", "f2_b",
    "modf_w", "modf_b", "out1_w", "out1_b", "out2_w",
)


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


class PackedTrunk(NamedTuple):
    """Trunk weights in one contiguous float32 buffer.

    ``offsets[name] = (float offset, shape)``; each entry starts on a
    16-byte boundary. ``output_multiplier`` is a plain float."""

    buffer: torch.Tensor
    offsets: Dict[str, Tuple[int, Tuple[int, ...]]]
    latent_dim: int
    hidden_dim: int
    num_layers: int
    output_multiplier: float

    def views(self) -> Dict[str, torch.Tensor]:
        return {
            name: self.buffer[off : off + math.prod(shape)].view(shape)
            for name, (off, shape) in self.offsets.items()
        }


def pack_trunk_weights(weights: Dict[str, torch.Tensor]) -> PackedTrunk:
    """Pack ``extract_trunk_weights`` output into a ``PackedTrunk``."""
    offsets: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
    parts: List[torch.Tensor] = []
    cursor = 0
    for name in PACK_ORDER:
        t = weights[name].to(torch.float32).reshape(-1)
        offsets[name] = (cursor, tuple(weights[name].shape))
        pad = -t.numel() % 4
        parts.append(t)
        if pad:
            parts.append(t.new_zeros(pad))
        cursor += t.numel() + pad
    lp = weights["latent_proj_w"]
    return PackedTrunk(
        buffer=torch.cat(parts).contiguous(),
        offsets=offsets,
        latent_dim=lp.shape[0],
        hidden_dim=lp.shape[1],
        num_layers=weights["v_w"].shape[0],
        output_multiplier=float(weights["output_multiplier"].reshape(-1)[0]),
    )


def packed_trunk_weights(score_net) -> PackedTrunk:
    """The score network's ``PackedTrunk``, cached on the module. The cache
    key holds every parameter's storage pointer and version counter, so any
    load or in-place update of the weights rebuilds the buffer."""
    key = tuple((p.data_ptr(), p._version) for p in score_net.parameters())
    cached = getattr(score_net, "_packed_trunk", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    with torch.no_grad():
        packed = pack_trunk_weights(extract_trunk_weights(score_net))
    score_net._packed_trunk = (key, packed)
    return packed


def sweep_smem_bytes(latent_dim: int, hidden_dim: int) -> int:
    """Dynamic shared memory of one kernel block: for TB rows, the latent
    and score (each padded to a multiple of 4 columns), the residual stream,
    the normalised input, silu(cond) (H each), the modulation (2H) and the
    MLP hidden (4H), all float32. Mirrors ``smem_floats`` in the kernel."""
    d_pad = -(-latent_dim // 4) * 4
    return 4 * ROWS_PER_BLOCK * (2 * d_pad + 9 * hidden_dim)


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
    the kernel's ``philox_normal``. Key (seed, row), counter (step, col, 0,
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
    """Plain PyTorch version of the kernel, on any device. ``noise`` (K, B,
    D), when given, replaces the Philox draw (for tests that feed both
    packages the same numbers)."""
    w = weights.views()
    h_dim = weights.hidden_dim
    coeffs = sweep_coefficients(schedule, num_steps, deterministic)
    mult = weights.output_multiplier
    rows = torch.arange(z0.shape[0], device=z0.device)[:, None]
    cols = torch.arange(z0.shape[1], device=z0.device)[None, :]

    def adaln(x, sc, mod_w, mod_b):
        mod = sc @ mod_w + mod_b
        return F.layer_norm(x, (h_dim,), eps=LN_EPS) * (1.0 + mod[:, :h_dim]) + mod[:, h_dim:]

    z = z0
    for i in range(num_steps):
        sc = F.silu(obs_emb + t_embs[i][None, :])
        h = z @ w["latent_proj_w"] + w["latent_proj_b"]
        for l in range(num_layers):
            x1 = adaln(h, sc, w["mod1_w"][l], w["mod1_b"][l])
            h = h + ((x1 @ w["v_w"][l] + w["v_b"][l]) @ w["o_w"][l] + w["o_b"][l])
            x2 = adaln(h, sc, w["mod2_w"][l], w["mod2_b"][l])
            mlp = F.gelu(x2 @ w["f1_w"][l] + w["f1_b"][l], approximate="tanh")
            h = h + (mlp @ w["f2_w"][l] + w["f2_b"][l])
        hf = adaln(h, sc, w["modf_w"], w["modf_b"])
        o1 = F.silu(hf @ w["out1_w"] + w["out1_b"])
        score = torch.clamp(o1 @ w["out2_w"], -10.0, 10.0) * mult

        s1, s2, c1, c2, sd, mask = coeffs[i, :6]
        pz0 = (z + s1 * score) * s2
        z_next = c1 * pz0 + c2 * z
        if not deterministic and i < num_steps - 1:  # noise_mask is 1 here
            eps = noise[i] if noise is not None else philox_normal(seed, rows, i, cols)
            z_next = z_next + mask * sd * eps
        z = z_next
    return z


class _TrunkOffsets(ctypes.Structure):
    _fields_ = [(name, ctypes.c_longlong) for name in PACK_ORDER]


def _check_args(schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers):
    b, d = z0.shape
    h = obs_emb.shape[-1]
    device = z0.device
    tensors = {
        "z0": z0, "obs_emb": obs_emb, "t_embs": t_embs,
        "weights.buffer": weights.buffer, "schedule": schedule.betas,
    }
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, z0 on {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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
    """Run the full K-step denoise; returns z_0 (B, D) float32.

    A CUDA tensor launches the kernel (one launch, counted in
    ``fused_denoise_sweep.launches``) or raises; a CPU tensor runs
    ``denoise_sweep_reference``."""
    _check_args(schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers)
    if z0.device.type == "cpu":
        return denoise_sweep_reference(
            schedule, weights, z0, obs_emb, t_embs, seed, num_steps, num_layers,
            deterministic,
        )
    if z0.device.type != "cuda":
        raise NotImplementedError(f"no denoise sweep for device {z0.device}")

    b, d = z0.shape
    h = obs_emb.shape[-1]
    if h % 8:
        raise ValueError(f"the kernel needs hidden_dim % 8 == 0, got {h}")
    smem = sweep_smem_bytes(d, h)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"denoise sweep at latent_dim={d}, hidden_dim={h} needs {smem} bytes "
            f"of shared memory per block; the kernel's plan allows {MAX_SMEM_BYTES}"
        )
    for name, t in (("z0", z0), ("obs_emb", obs_emb), ("t_embs", t_embs)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")

    from ._build import load_library

    lib = load_library()
    coeffs = sweep_coefficients(schedule, num_steps, deterministic).contiguous()
    out = torch.empty_like(z0)
    offsets = _TrunkOffsets(*(weights.offsets[name][0] for name in PACK_ORDER))
    with torch.cuda.device(z0.device):
        stream = torch.cuda.current_stream(z0.device).cuda_stream
        err = lib.aid_denoise_sweep(
            z0.data_ptr(), obs_emb.data_ptr(), t_embs.data_ptr(), coeffs.data_ptr(),
            weights.buffer.data_ptr(), offsets, seed.data_ptr(), out.data_ptr(),
            b, d, h, num_layers, num_steps, weights.output_multiplier,
            0 if deterministic else 1, smem, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"denoise_sweep launch failed: {lib.aid_cuda_error_string(err).decode()} ({err})"
        )
    fused_denoise_sweep.launches += 1
    return out


fused_denoise_sweep.launches = 0
