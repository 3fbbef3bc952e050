#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the port's CUDA kernel from the sources in this checkout, holds it
against its plain PyTorch version, drives the state agent's acting path
(``DiffusionStateAgent.act``) at the flagship width, and times both. Any
failed phase raises, so the script exits non-zero; without a CUDA device it
exits non-zero before printing a result. It imports no JAX.

Phases:
1. device: the card's name and power limit; TF32 off for matmul and cuDNN.
2. build: ``nvcc`` for sm_90a, with the build seconds.
3. kernel vs plain version at seeded random weights (every parameter normal
   / sqrt(fan_in), output_multiplier 1.0): the flagship shape, the
   halfcheetah_state.yaml widths (full and partial sweep) and a ragged
   batch, each deterministic and stochastic with the same seed.
4. main path: 40 ``agent.act`` calls (20 batches of 256 observations, eval
   and collect mode) at the flagship config; actions finite, (256, 6),
   within [-1, 1]; one kernel launch per call; eval actions equal to the
   plain path's (the same agent on the CPU, from the same start draw).
5. times: the sweep, kernel against plain, at the flagship width (CUDA
   events); ``act`` latency at batch 1 and 256 (host clock, synchronised).
6. the kernel summary line, the card line, and the result line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

OBS_DIM, ACT_DIM = 17, 6  # HalfCheetah-v4
# Flagship width (bench.py:235-238): batch 256, latent 32, hidden 128,
# 6 DiT blocks, K = 25 cosine.
FLAGSHIP = dict(batch=256, latent=32, hidden=128, layers=6, schedule=25)
# (name, batch, latent, hidden, layers, schedule length, sweep steps)
PARITY_SHAPES = [
    ("flagship", 256, 32, 128, 6, 25, 25),
    # examples/configs/halfcheetah_state.yaml, full sweep and its collect sweep
    ("halfcheetah_state", 256, 50, 256, 6, 100, 100),
    ("halfcheetah_state_collect", 256, 50, 256, 6, 100, 50),
    ("ragged", 37, 32, 128, 6, 25, 25),
]
# Kernel vs plain sweep, elementwise |kernel - plain| <= ATOL + RTOL |plain|:
# float32 on both sides with another summation order, compounded over up to
# 100 dependent steps of 6 blocks.
SWEEP_RTOL, SWEEP_ATOL = 1e-3, 1e-4
# Eval actions (tanh of the policy mean, clipped) of the card against the CPU.
ACT_ATOL = 1e-4
ACT_CALLS_PER_MODE = 20
TIMED_CALLS, WARMUP_CALLS = 25, 3


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def randomize(module: torch.nn.Module, seed: int) -> None:
    """Seeded normal weights scaled by 1/sqrt(fan_in) (1/sqrt(n) for
    vectors); output_multiplier 1.0, so the score head is not near zero."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan_in = p.shape[-1] if p.dim() == 2 else p.shape[0]
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in**0.5)
            if name.endswith("output_multiplier"):
                p.fill_(1.0)


def cuda_ms(fn, calls: int) -> list:
    """Per-call device milliseconds from CUDA events."""
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def host_ms(fn, calls: int) -> list:
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def main() -> int:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    from active_inference_diffusion_torch import (
        ActiveInferenceConfig,
        DiffusionConfig,
        DiffusionStateAgent,
        TrainingConfig,
    )
    from active_inference_diffusion_torch.core.schedules import make_schedule
    from active_inference_diffusion_torch.models.score_network import LatentScoreNetwork
    from active_inference_diffusion_torch.ops import _build
    from active_inference_diffusion_torch.ops.denoise import (
        denoise_sweep_reference,
        fused_denoise_sweep,
        packed_trunk_weights,
    )

    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    _build.load_library()
    log(f"[2 build] {_build.LIBRARY} in {time.perf_counter() - t0:.2f} s")
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build] ptxas: {line.strip()}")

    # -- 3. kernel vs plain version -----------------------------------------
    def sweep_inputs(batch, latent, hidden, layers, schedule_len, steps, seed):
        net = LatentScoreNetwork(latent, OBS_DIM, hidden_dim=hidden, num_layers=layers).to(dev)
        randomize(net, seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        z0 = torch.randn((batch, latent), generator=gen, device=dev)
        obs = torch.randn((batch, OBS_DIM), generator=gen, device=dev)
        with torch.no_grad():
            obs_emb = net.obs_embedding(obs).contiguous()
            t = torch.arange(steps - 1, -1, -1, device=dev, dtype=torch.float32)
            t_embs = net.time_embedding(t, continuous=False).contiguous()
        seed_t = torch.tensor(1234 + seed, dtype=torch.int64, device=dev)
        schedule = make_schedule(schedule_len, "cosine", device=dev)
        return schedule, packed_trunk_weights(net), z0, obs_emb, t_embs, seed_t, steps, layers

    max_abs_err = 0.0
    for i, (name, batch, latent, hidden, layers, k_sched, steps) in enumerate(PARITY_SHAPES):
        args = sweep_inputs(batch, latent, hidden, layers, k_sched, steps, seed=i)
        for deterministic in (True, False):
            got = fused_denoise_sweep(*args, deterministic=deterministic)
            want = denoise_sweep_reference(*args, deterministic=deterministic)
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and got.shape == want.shape):
                raise RuntimeError(f"{name}: kernel output not finite or misshapen")
            err = (got - want).abs()
            bound = SWEEP_ATOL + SWEEP_RTOL * want.abs()
            worst = float((err / bound).max())
            max_abs_err = max(max_abs_err, float(err.max()))
            log(f"[3 parity] {name} B={batch} D={latent} H={hidden} L={layers} "
                f"K={steps}/{k_sched} {'det' if deterministic else 'sto'}: "
                f"max|err| {float(err.max()):.3e} max|plain| {float(want.abs().max()):.3e} "
                f"err/tol {worst:.3f} (tol {SWEEP_ATOL:g} + {SWEEP_RTOL:g}|plain|)")
            if worst > 1.0:
                raise RuntimeError(f"{name}: kernel disagrees with its plain version")

    # -- 4. main path -------------------------------------------------------
    cfg = ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=ACT_DIM, latent_dim=FLAGSHIP["latent"],
        hidden_dim=FLAGSHIP["hidden"], score_num_layers=FLAGSHIP["layers"],
        batch_size=FLAGSHIP["batch"], kl_weight=0.5,
        diffusion=DiffusionConfig(num_diffusion_steps=FLAGSHIP["schedule"], beta_schedule="cosine"),
    )
    cfg.tpu.use_pallas_denoiser = True
    # 20 collect steps on a 25-step schedule, as the upstream HalfCheetah entry point runs
    training = TrainingConfig(collect_diffusion_steps=20)
    agent = DiffusionStateAgent(OBS_DIM, ACT_DIM, cfg, training, device=dev)
    randomize(agent.core, seed=100)
    twin = DiffusionStateAgent(OBS_DIM, ACT_DIM, cfg, training, device="cpu")
    twin.core.load_state_dict(agent.core.state_dict())

    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((FLAGSHIP["batch"], OBS_DIM)).astype(np.float32)
               for _ in range(ACT_CALLS_PER_MODE)]
    gen = torch.Generator(device=dev).manual_seed(0)
    eval_runs = []
    fused_denoise_sweep.launches = 0
    for obs in batches:
        state = gen.get_state()
        eval_runs.append((obs, state, agent.act(obs, gen, deterministic=True, collect=False)))
        collect = agent.act(obs, gen, deterministic=False, collect=True)
        for actions in (eval_runs[-1][2], collect):
            if actions.shape != (FLAGSHIP["batch"], ACT_DIM) or not np.isfinite(actions).all():
                raise RuntimeError(f"act returned {actions.shape}, finite={np.isfinite(actions).all()}")
            if np.abs(actions).max() > 1.0:
                raise RuntimeError("act returned actions outside [-1, 1]")
    launches = fused_denoise_sweep.launches
    calls = 2 * ACT_CALLS_PER_MODE
    log(f"[4 main path] {calls} act calls, {launches} kernel launches")
    if launches != calls:
        raise RuntimeError(f"expected one kernel launch per act call, got {launches}/{calls}")

    act_err = 0.0
    replay = torch.Generator(device=dev)
    for obs, state, actions in eval_runs:
        replay.set_state(state)
        z0, seed = agent.core.draw_start(obs.shape[0], replay)
        plain = twin.act_from_start(
            torch.from_numpy(obs), z0.cpu(), seed.cpu(), None, deterministic=True
        ).numpy()
        act_err = max(act_err, float(np.abs(plain - actions).max()))
    log(f"[4 main path] eval actions vs plain path (CPU): max|err| {act_err:.3e} (tol {ACT_ATOL:g})")
    if act_err > ACT_ATOL:
        raise RuntimeError("the card's actions disagree with the plain path")

    # -- 5. times -----------------------------------------------------------
    args = sweep_inputs(**{k: FLAGSHIP[k] for k in ("batch", "latent", "hidden", "layers")},
                        schedule_len=FLAGSHIP["schedule"], steps=FLAGSHIP["schedule"], seed=7)
    arms = {
        "kernel": lambda: fused_denoise_sweep(*args, deterministic=False),
        "plain": lambda: denoise_sweep_reference(*args, deterministic=False),
    }
    samples = {name: [] for name in arms}
    for name in arms:
        cuda_ms(arms[name], WARMUP_CALLS)
    for name in ("plain", "kernel", "kernel", "plain"):
        samples[name] += cuda_ms(arms[name], (TIMED_CALLS + 1) // 2)
    sweep_ms = {name: statistics.median(v) for name, v in samples.items()}
    for name in ("kernel", "plain"):
        log(f"[5 times] sweep {name}: median {sweep_ms[name]:.4f} ms over {len(samples[name])} "
            f"calls (B=256 D=32 H=128 L=6 K=25, stochastic) | {card}")

    act_ms = {}
    for batch in (1, FLAGSHIP["batch"]):
        obs = batches[0][:batch]
        for _ in range(WARMUP_CALLS):
            agent.act(obs, gen, deterministic=True, collect=False)
        act_ms[batch] = statistics.median(
            host_ms(lambda: agent.act(obs, gen, deterministic=True, collect=False), TIMED_CALLS)
        )
        log(f"[5 times] act latency b={batch}: median {act_ms[batch]:.4f} ms over "
            f"{TIMED_CALLS} calls (eval, K=25) | {card}")

    # -- 6. summary ---------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "denoise_sweep",
        "route": "cuda",
        "source": "active_inference_diffusion_torch/csrc/denoise_sweep.cu",
        "replaces": "active_inference_diffusion_tpu/ops/denoise.py:159",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": sweep_ms["kernel"],
        "plain_ms": sweep_ms["plain"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
