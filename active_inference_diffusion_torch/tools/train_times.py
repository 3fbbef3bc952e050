"""Time the flagship train update on the card.

    python active_inference_diffusion_torch/tools/train_times.py [--tree DIR]
        [--variant v1|v2] [--steps 10] [--profiled 5] [--label TEXT]
        [--epoch [--updates 256]]

It builds the flagship trainer with ``chip_smoke.py``'s
``flagship_agent(device, train=True)`` (HalfCheetah-v4, batch 256, latent
32, hidden 128, 6 DiT blocks, K=25, ``kl_weight`` 0.5; the Flax
initialisers from seed 300, the score network ``randomize``d), with the
sweep variant ``--variant``, takes 3 warm-up ``train_step``s on one seeded
batch, times ``--steps`` more on the host clock (synchronised) and profiles
``--profiled`` more with ``chip_smoke.py``'s ``profile_ms``. It times the
package of one checkout: this one, or ``--tree DIR``, another checkout of
the repository (for example the parent commit unpacked with ``git
archive``); the agent, batch and timing come from this checkout's
``chip_smoke.py`` in either case. Prints one JSON line with the card's name
and power limit. To compare two trees, run it for each, in turns (parent,
change, change, parent), on the same card. Needs a CUDA device.

With ``--epoch`` it times ``train_epoch`` instead, as ``chip_smoke.py``'s
phase 5 does: a ring of 100,000 seeded transitions (``fill_ring``), two
trainers with the same weights, 3 warm-up updates of the eager loop and 10
of the graphs, then ``--updates`` updates of each, the eager loop of
``train_step_from_draws`` against graph replays, in blocks of 16 in turns
(``epoch_times``: median ms per update, updates/s), and ``--profiled``
replays under torch.profiler (``profile_epoch``: device time and busy
share, launches per update outside the graph, the sweep's time). The tree
timed needs ``train_epoch``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[2])
    parser.add_argument("--variant", choices=("v1", "v2"), default="v1")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--profiled", type=int, default=5)
    parser.add_argument("--label", default="")
    parser.add_argument("--epoch", action="store_true")
    parser.add_argument("--updates", type=int, default=256)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("train_times needs a CUDA device")
    sys.path.insert(0, str(args.tree.resolve()))  # the package timed
    own = Path(__file__).resolve().parents[2] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", own)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    FLAGSHIP, flagship_agent, host_ms, nvidia_smi, profile_ms, train_batch = (
        smoke.FLAGSHIP, smoke.flagship_agent, smoke.host_ms, smoke.nvidia_smi,
        smoke.profile_ms, smoke.train_batch)
    if args.epoch:
        return epoch(smoke, args)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    agent = flagship_agent(dev, train=True)
    agent.config.tpu.denoiser_kernel = args.variant
    state = agent.new_train_state(304)
    batch = train_batch(FLAGSHIP["batch"], 310, dev)

    def step():
        nonlocal state
        state, _ = agent.train_step(state, batch)

    for _ in range(3):
        step()
    times = host_ms(step, args.steps)
    prof = profile_ms(step, args.profiled, "denoise_sweep")
    print(json.dumps(dict(
        label=args.label, tree=str(args.tree), variant=args.variant, batch=FLAGSHIP["batch"],
        median_ms=statistics.median(times), min_ms=min(times), max_ms=max(times),
        profiled_host_ms=prof["host_ms"], device_ms=prof["device_ms"],
        sweep_ms=prof["named_ms"], kernels=prof["kernels_per_call"],
        phases_host_ms=prof["phases_host_ms"], card=nvidia_smi(),
    )), flush=True)
    return 0


def epoch(smoke, args) -> int:
    """``--epoch``: the eager loop against graph replays of ``train_epoch``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    ring, _ = smoke.fill_ring(dev)
    eager, graph = (smoke.flagship_agent(dev, train=True) for _ in range(2))
    for agent in (eager, graph):
        agent.config.tpu.denoiser_kernel = args.variant
    eager_state, _ = smoke.eager_updates(eager, eager.new_train_state(304), ring.state, 3)
    graph_state, _ = graph.train_epoch(graph.new_train_state(304), ring.state, 10)
    eager_state, graph_state, times = smoke.epoch_times(eager, eager_state, graph, graph_state,
                                                        ring.state, updates=args.updates)
    graph_state, prof = smoke.profile_epoch(graph, graph_state, ring.state, args.profiled)
    print(json.dumps(dict(
        label=args.label, tree=str(args.tree), variant=args.variant,
        batch=smoke.FLAGSHIP["batch"], epoch=times, profiled=prof, card=smoke.nvidia_smi(),
    )), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
