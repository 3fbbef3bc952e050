"""torch.profiler sessions over replays of many live CUDA graphs.

    python active_inference_diffusion_torch/tools/cupti_probe.py [--rounds 12]
        [--teardown default|0|1]

A probe of the segfault that ``chip_smoke.py`` met inside a profiled graph
replay. Each round, outside any profiler session, captures the update of
the HalfCheetah learning preset anew (a fresh ``EpochGraphs`` over a ring
of 100,000 seeded transitions, the agent of ``chip_smoke.py``'s
``dreamer_agent``) and a fresh Pendulum collect of 1024 envs x 8 steps
with the v1-f32 sweep kernel in its step graph (``chip_smoke.py``'s
``fused_run``); then, in one torch.profiler session, it replays two
updates of the first and of the newest update graphs and one collect of
the first and of the newest collect, and checks that the trace holds one
sweep kernel a replayed env step. Every graph stays alive to the end.

``--teardown`` sets ``TEARDOWN_CUPTI``, which torch.profiler's CUPTI layer
(kineto) reads when a session ends: ``1`` tears CUPTI down after each
session and sets it up again at the next (PyTorch's note in
``torch/profiler/profiler.py`` says that can crash with CUDA graphs),
``0`` keeps it up, ``default`` leaves the variable unset. With
``KINETO_LOG_LEVEL=0`` in the environment kineto logs each teardown
(``teardownCupti starting``). Prints one JSON line a round (the session's
seconds, CUPTI's set-up and tear-down among them) and ``done`` with the
card's name and power limit; a crash ends the process with its signal.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rounds", type=int, default=12)
    parser.add_argument("--teardown", choices=("default", "0", "1"), default="default")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("cupti_probe needs a CUDA device")
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    own = root / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", own)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT"):
        os.environ.pop(name, None)
    if args.teardown != "default":
        os.environ["TEARDOWN_CUPTI"] = args.teardown
    if args.teardown == "0":
        os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"

    from torch.profiler import ProfilerActivity, profile

    from active_inference_diffusion_torch import train_fused
    from active_inference_diffusion_torch.agents.graphs import EpochGraphs

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    agent = smoke.dreamer_agent("halfcheetah", dev)
    ring, _ = smoke.fill_ring(dev, 420, *smoke.DREAMER_SHAPES["halfcheetah"])
    state = agent.new_train_state(402)
    batch = agent.config.batch_size
    updates, runs = [], []

    def collect(run) -> None:
        run.env_states, run.policy_state, _ = train_fused.collect_and_store(
            run.agent, run.state, run.collector, run.replay, run.env_states, run.policy_state,
            run.generator, 0.1)

    for round_ in range(args.rounds):
        updates.append(EpochGraphs(agent))
        updates[-1].run(state, ring.state, batch, 2)
        runs.append(smoke.fused_run("--num-envs", "1024", "--steps-per-iter", "8",
                                    seed=500 + 10 * round_))
        collect(runs[-1])
        torch.cuda.synchronize()
        replayed = {id(g): g for g in (updates[0], updates[-1])}
        collected = {id(r): r for r in (runs[0], runs[-1])}
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for graphs in replayed.values():
                graphs.run(state, ring.state, batch, 2)
            for run in collected.values():
                collect(run)
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        sweeps = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                     and "denoise_sweep" in e.name)
        want = 8 * len(collected)
        print(json.dumps({"round": round_, "teardown": args.teardown, "session_s": seconds,
                          "update_graphs": len(updates), "collect_graphs": len(runs),
                          "sweep_kernels": sweeps, "want": want}), flush=True)
        if sweeps != want:
            raise RuntimeError(f"{sweeps} sweep kernels in the trace, expected {want}")
    print(f"done {args.rounds} rounds | {smoke.nvidia_smi()}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
