"""Time the sweep kernels on the card at the humanoid_state.yaml width.

    python -m active_inference_diffusion_torch.tools.sweep_times [--kernels ...]
        [--batches 8 256] [--steps 50] [--calls 10] [--label TEXT]

Run from the repository root: it takes ``chip_smoke.py``'s seeded inputs,
tolerances and timer. For each kernel and batch it holds one deterministic
and one stochastic sweep against the plain version, then times stochastic
sweeps with CUDA events (median of ``--calls`` after warm-up). One JSON
object per line on standard output, each with the card's name and power
limit. To compare two trees, run it from each, in turns, on the same card.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics

import torch

from chip_smoke import SWEEP_TOL, WARMUP_CALLS, cuda_ms, nvidia_smi, sweep_inputs

from ..ops import _build
from ..ops.denoise import KERNELS, denoise_sweep_reference, kernel_smem_bytes

HUMANOID = dict(latent=64, hidden=256, layers=6, obs_dim=376)  # Humanoid-v4


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", nargs="+", default=sorted(KERNELS))
    parser.add_argument("--batches", nargs="+", type=int, default=[8, 256])
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_times needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    for kernel in args.kernels:
        variant, dtype, library, _ = KERNELS[kernel]
        for batch in args.batches:
            wrapper, sweep = sweep_inputs(kernel, batch, **HUMANOID, schedule_len=args.steps,
                                          steps=args.steps, seed=7)
            rtol, atol = SWEEP_TOL[dtype]
            err, worst = 0.0, 0.0
            for deterministic in (True, False):
                got = wrapper(*sweep, deterministic=deterministic)
                want = denoise_sweep_reference(*sweep, deterministic=deterministic)
                if not torch.isfinite(got).all():
                    raise RuntimeError(f"{kernel} B={batch}: output not finite")
                diff = (got - want).abs()
                err = max(err, float(diff.max()))
                worst = max(worst, float((diff / (atol + rtol * want.abs())).max()))
            run = lambda: wrapper(*sweep, deterministic=False)  # noqa: E731
            cuda_ms(run, WARMUP_CALLS)
            row = dict(label=args.label, kernel=kernel, batch=batch, steps=args.steps,
                       ms=statistics.median(cuda_ms(run, args.calls)), max_abs_err=err,
                       err_over_tol=worst, card=card)
            if dtype == torch.bfloat16:  # clusters the card holds at once with this plan
                count = ctypes.c_int(0)
                smem = kernel_smem_bytes(HUMANOID["latent"], HUMANOID["hidden"], variant, dtype)
                _build.load_library(library).aid_sweep_bf16_max_clusters(
                    1 if variant == "v1" else 2, smem, ctypes.byref(count))
                row["max_active_clusters"] = count.value
            print(json.dumps(row), flush=True)
            if worst > 1.0:
                raise RuntimeError(f"{kernel} B={batch}: kernel disagrees with its plain version")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
