"""Profile one humanoid_state.yaml ``act`` call on the card.

    python -m active_inference_diffusion_torch.tools.profile_act [--batch 256] [--calls 5]

Run from the repository root. Builds the humanoid_state.yaml agent (its v1
bf16 sweep; random weights from a seed by ``chip_smoke.py``'s
``randomize``), warms it up, then runs ``--calls`` eval ``act`` calls under
``torch.profiler`` (CPU and CUDA activities). Prints, as JSON lines: the
host time per call, the device time per call summed over kernels, the
share of the call's span the device was busy, and the kernels that took the
most device time, with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from chip_smoke import nvidia_smi, randomize

from ..agents.state_agent import DiffusionStateAgent
from ..configs.presets import HUMANOID_ACT_DIM, HUMANOID_OBS_DIM, humanoid_state


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--calls", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_act needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    cfg, training = humanoid_state()
    agent = DiffusionStateAgent(HUMANOID_OBS_DIM, HUMANOID_ACT_DIM, cfg, training)
    randomize(agent.core, seed=200)
    obs = np.random.default_rng(1).standard_normal((args.batch, HUMANOID_OBS_DIM))
    obs = obs.astype(np.float32)
    g = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(3):
        agent.act(obs, g, deterministic=True, collect=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            agent.act(obs, g, deterministic=True, collect=False)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.calls
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / args.calls
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / args.calls
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    rows = [
        dict(what="act", batch=args.batch, host_ms_per_call=host_ms,
             device_ms_per_call=device_ms, device_busy_share=device_ms / host_ms,
             kernels_per_call=len(kernels) / args.calls, card=nvidia_smi()),
        *(dict(what="top_kernel", name=name[:80], device_ms_per_call=ms) for name, ms in top),
    ]
    for row in rows:
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
