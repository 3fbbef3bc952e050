"""Time the sweep kernels on the card at the flagship or humanoid_state.yaml width.

    python active_inference_diffusion_torch/tools/sweep_times.py [--tree DIR]
        [--width humanoid|flagship] [--kernels ...] [--batches 8 256] [--calls 10]
        [--label TEXT] [--parity]

It takes ``chip_smoke.py``'s seeded inputs, tolerances and timer from the
checkout it times: this one, or ``--tree DIR``, another checkout of the
repository (for example the parent commit unpacked with ``git archive``),
whose ``chip_smoke.py`` and package it imports instead. For each kernel and
batch it holds one deterministic and one stochastic sweep against the plain
version, then times stochastic sweeps with CUDA events (median of
``--calls`` after warm-up), with the full sweep of the width's schedule.
One JSON object per line on standard output, each with the card's name and
power limit. To compare two trees, run it for each, in turns (parent,
change, change, parent), on the same card. With ``--parity`` it times
nothing and holds the kernels at chip_smoke.py's parity rows instead (its
``parity_rows``: each row's seed, full sweeps), one line per sweep with
max |err| and err/tol, without stopping at a row over its tolerance.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

WIDTHS = {  # latent, hidden, layers, observation width, schedule (= sweep) length
    "humanoid": dict(latent=64, hidden=256, layers=6, obs_dim=376, steps=50),  # Humanoid-v4
    "flagship": dict(latent=32, hidden=128, layers=6, obs_dim=17, steps=25),  # HalfCheetah-v4
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2])
    parser.add_argument("--width", choices=sorted(WIDTHS), default="humanoid")
    parser.add_argument("--kernels", nargs="+")
    parser.add_argument("--batches", nargs="+", type=int, default=[8, 256])
    parser.add_argument("--calls", type=int, default=10)
    parser.add_argument("--label", default="")
    parser.add_argument("--parity", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("sweep_times needs a CUDA device")
    sys.path.insert(0, str(args.tree.resolve()))
    from active_inference_diffusion_torch.ops.denoise import KERNELS, denoise_sweep_reference
    from chip_smoke import SWEEP_TOL, WARMUP_CALLS, cuda_ms, nvidia_smi, parity_rows, sweep_inputs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = nvidia_smi()
    if args.parity:
        for row in parity_rows(args.kernels):
            print(json.dumps(dict(label=args.label, tree=str(args.tree), **row, card=card)),
                  flush=True)
        return 0
    width = dict(WIDTHS[args.width])
    steps = width.pop("steps")
    for kernel in args.kernels or sorted(KERNELS):
        dtype = KERNELS[kernel][1]
        for batch in args.batches:
            wrapper, sweep = sweep_inputs(kernel, batch, **width, schedule_len=steps,
                                          steps=steps, seed=7)
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
            row = dict(label=args.label, tree=str(args.tree), width=args.width, kernel=kernel,
                       batch=batch, steps=steps, ms=statistics.median(cuda_ms(run, args.calls)),
                       max_abs_err=err, err_over_tol=worst, card=card)
            print(json.dumps(row), flush=True)
            if worst > 1.0:
                raise RuntimeError(f"{kernel} B={batch}: kernel disagrees with its plain version")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
