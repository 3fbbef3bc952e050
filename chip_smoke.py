#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version, drives the state agent's acting
paths (``DiffusionStateAgent.act`` and ``act_warm``) through every kernel
and the flagship train update (``train_step``, and ``train_epoch`` over a
device replay ring, each update a replayed CUDA graph) through the float32
ones, runs the widths beyond the kernels' 48 MiB of trunk weights through
the plain sweep on the card, drives the learning presets
(``*_state_dreamer.yaml``: posterior beliefs, the imagined actor-critic,
no sweep) through ``train_step``, ``train_epoch`` and ``act``, drives the
fused collect+train loop (``train_fused``: device envs, the planar and the
3D engines, each env step a replayed CUDA graph with the sweep kernel inside
it), and times them. Any failed phase raises, so the script exits non-zero;
without a CUDA device it exits non-zero before printing a result. It
imports no JAX and nothing of the JAX package.

Phases:
1. device: the card's name and power limit; TF32 off for matmul and cuDNN.
2. build: one ``nvcc`` per source for sm_90a, all started together (one
   source, ``csrc/denoise_sweep_cluster.cu``, holds the four kernels), with
   the build seconds, ptxas's register/spill report and the clusters of 8
   the card holds at once for each kernel at the two widths (resident
   plan) and at the config's default width (streamed plan).
3. kernels vs plain version at seeded random weights (every parameter
   normal / sqrt(fan_in), output_multiplier 1.0), each deterministic and
   stochastic with the same seed: v1-f32 at the flagship (B=256 and 1), the
   halfcheetah_state.yaml widths (full and partial sweep) and a ragged
   batch; v1-bf16 and v2-bf16 at the humanoid_state.yaml width at B=256
   (K=50 full; v1 also 25 partial), B=8 (one cluster), B=37 (a ragged
   cluster) and B=512, K=10 (two waves of clusters; the K of
   humanoid3d_fused.yaml); v2-f32 at the flagship and the humanoid width
   (B=256 and 8); v1-f32 at the flagship width, B=512 (the train step's
   belief sweep); the streamed plan at the config's default width (latent
   128, hidden 512) in bf16 (v1 B=8, v2 B=37, K=100) and in f32 at hidden
   300 (v1 B=256, v2 B=512); hidden 96, padded to 128 (f32, B=8 and 37);
   v1-f32 at the HalfCheetah learning preset's width, B=16, K=15 (C4), and
   at the fused collect's (latent 16, hidden 64, 2 blocks, K=10: B=1024,
   its warm start's K=3, B=512, the eval's B=64 and the Ant3D collect's
   B=256).
4. main paths, each with every launch count set to 0 just before it and
   read just after; actions finite, (B, A), within [-1, 1]; exactly one
   launch per call of the path's kernel and none of another; eval actions
   equal to the plain path's (the same agent on the CPU, from the same start
   draws):
   a. flagship config, v1-f32: 20 ``act`` calls at batch 256 in eval and in
      collect mode;
   b. flagship config with ``denoiser_kernel="v2"``, v2-f32: 5 + 5 calls;
   c. humanoid_state.yaml (bfloat16, Fokker-Planck refinement), v1-bf16:
      20 + 20 ``act`` calls at batch 256 and at batch 8, then 4
      ``act_warm`` calls at each batch with a ``reset_mask``;
   d. the same with ``denoiser_kernel="v2"``, v2-bf16;
   c1: ``act`` and ``generate_beliefs`` at the widths C1 found refused
   (``C1_WIDTHS``): beyond the kernels' 48 MiB two plain runs on the card
   (``PLAIN_RUNS``) and no launch, within it two launches and no plain run;
   the CPU twin's actions, latents and reconstruction error;
   e. the flagship train update at batch 256: 5 v1 then 2 v2
   ``train_step`` calls, one sweep launch each and none of another
   kernel, every loss finite, every partition moving, the MINE update on
   every 5th step only; then per variant one deterministic step from
   fresh states with ``TrainDraws`` shared with the CPU twin, held by
   ``compare_train_steps``, and for v1 a control step with TF32 products,
   which must fail the MINE gradient's limit;
   f. the replay ring and ``train_epoch`` (``epoch_phase``): a ring of
   ``TrainingConfig.buffer_size`` (100,000) filled with 120,000 seeded
   transitions, pos, size and a wrapped slot checked against a numpy model;
   per variant two trainers with the same weights run steps 0-9 (MINE at 0
   and 5) from the same state and draws, one as the eager loop of
   ``train_step_from_draws``, one as ten ``train_epoch`` calls of one graph
   replay each: every metric, every partition's parameters and moments, the
   time importance, reward normaliser and MINE running mean within the
   train check's tolerances (the largest difference printed), one sweep
   launch per replay and per capture's warm-up, and ``act`` after the
   epoch equal to the eager twin's; for v1 also an epoch of 300 updates
   in chunks of 150 and 150.
   g. the learning presets (``dreamer_phase``), the three
   ``*_state_dreamer.yaml`` loaded from their files at their published
   widths (batch 128, latent 32, hidden 128, 6 blocks, 5 dynamics members,
   5 x 10 imagined trajectories) and the environments' dimensions, Flax
   initialisers from a seed and the score network ``randomize``d: per
   preset one update with explicit draws against the CPU twin (the train
   check, the slow critic, return scale, log_alpha and EMA policy among the
   state's fields); steps 0-9 as graph replays against the eager loop; for
   Hopper also a copy with ``policy_anchor_warmup_steps=5``, ten updates in
   one ``train_epoch`` call, whose four kinds of captured update show the
   anchor's gate opening inside it; posterior acting with the trained state
   at batch 16 and 256 against the CPU twin (``act`` eval and collect,
   ``act_warm``, ``act`` with ``compute_efe_info``); no sweep launched in
   any of it. Then C4: the HalfCheetah preset with
   posterior acting off and ``use_ema_for_act`` on acts with the state's
   score EMA (one v1-f32 sweep launch), against the CPU twin and unlike the
   live network.
   h. (run after phase 5's other times) the fused collect+train loop
   (``fused_phase``), each run set up by
   ``train_fused.build_run`` as ``python -m
   active_inference_diffusion_torch.train_fused`` sets it up, the Flax
   initialisers from a seed and the score network ``randomize``d. Pendulum-v1
   at the entry point's defaults (latent 16, hidden 64, 2 blocks, K=10;
   bench.py:740-841's shape), 1024 envs x 64 steps, then with warm starts
   at K=3: two collects each through ``collect_and_store`` (one captured env
   step replayed per step, the v1-f32 sweep kernel inside it), exactly one
   sweep launch per env step and no plain run, the transitions and physics
   finite, the first collect's steps 0-3 against the eager loop on the card
   and steps 0-1 against the CPU twin, on the same draws; its
   ``fused_eval`` of 64 envs x one 200-step episode, one launch a step.
   HopperPlanar-v0 at 512 x 32 (bench.py:860-890) and Walker2dPlanar-v0 at
   64 x 16 with the same checks. halfcheetah_planar_fused.yaml at its
   published widths (latent 32, hidden 128, 6 blocks, K=10, batch 128, 5
   dynamics members, posterior acting) in the README's loop shape: 3
   ``train_fused.iterate`` calls of 64 envs x 16 steps and 64
   ``train_epoch`` updates (graph replays) from an empty ring, metrics
   finite, the ring's size and position equal to the env steps stored, no
   sweep; then one ``fused_eval`` of 64 envs cut to 100 of its 1000 steps,
   to keep the script within its time.
   i. (run after 4h's times) ``[4 rigid3d]`` (``rigid3d_phase``), the 3D
   engine in the fused loop, each run set up by ``train_fused.build_run``:
   Ant3D-v0 at bench.py:1036-1089's shape (256 envs x 16 steps, train_fused's
   defaults: latent 16, hidden 64, 2 blocks, K=10) with the sweep acting,
   then Humanoid3D-v0 and HumanoidStandup3D-v0 at 64 x 8 with the same
   policy, each with 4h's collect checks (one sweep launch an env step, no
   plain run, graph replays against the eager loop over steps 0-3, the CPU
   twin over steps 0-1, physics finite) and its observation width (27,
   376, 376); humanoid3d_fused.yaml at its published widths (latent 64,
   hidden 256, 6 blocks, K=10, batch 128, 5 members, posterior acting, bf16
   sweep weights) in the README's loop, 2 iterations of 64 envs x 16 steps
   and 64 ``train_epoch`` updates from an empty ring, and one iteration of
   ant3d_fused.yaml, each with 4h's preset checks and an eval of 16 envs
   cut to 100 of its 1000 steps for chip time.
   j. ``[4 ground]`` (``ground_phase``): halfcheetah_state_tuned.yaml (grounded
   beliefs) from its file at its published widths (latent 32, hidden 128, 6 blocks,
   K=15, batch 128) and HalfCheetah-v4's dimensions: one update with explicit draws
   (the sweep's start and every step's noise) against the CPU twin, its
   differentiated sweep of 256 rows one plain run (``PLAIN_RUNS``) and no kernel
   launch; steps 0-9 as graph replays against the eager loop; a copy with
   ``policy_lr_decay_steps`` 4 over steps 0-5, the policy's rate (a device tensor
   in the graph) and parameters step by step; one ``act`` of the trained agent (one
   v1-f32 launch); ``train_fused`` with the preset on HalfCheetahPlanar-v0, its
   collect checked as 4h's (the v1-f32 kernel at B=64, K=15: one launch an env
   step, graph against the eager loop, card against the CPU twin at 1e-3), then 2
   iterations of 64 envs x 16 steps and 64 ``train_epoch`` updates; C5: the
   Humanoid family's env steps in float64 and float32 on the card against the CPU
   from the same states and actions.
   k. ``[4 resume]`` (``resume_phase``): ``train_fused`` with the tuned preset on
   Pendulum-v1 and ``--checkpoint-dir --eval-every 1 --save-replay`` for 2
   iterations, a ``--resume`` of its ``final`` checkpoint (every tensor of the
   train state, the generator and the ring equal to the saved run's, the step
   count and best eval carried), the next update of both runs on the same ring
   and draws (equal), one iteration of the resumed run, and a resume without the
   ring that refills it with no update.
5. times: each kernel against its plain version at its main path's shape
   (CUDA events), and at the other shapes of the timed list; for every row
   the plain version captured once in a CUDA graph and replayed
   (``library_ms``: cuBLAS products and PyTorch's elementwise kernels
   without the host's launch cost, TF32 off), and for the bf16 rows also
   that graph with bf16 x bf16 cuBLAS products summed in float32 (a tighter
   yardstick, ``plain_bf16_products``); both are measured here only, the
   port never calls them.
   ``act`` latency (host clock, synchronised) at the flagship (batch 1,
   256) and the humanoid config (batch 8, 256), eval and collect.
   ``train_step`` at the flagship, batch 256, v1 and v2: median of 10
   (host clock, synchronised) after 3 warm-up steps.
   ``train_epoch`` at the flagship, v1 (``epoch_times_phase``): the eager
   loop against graph replays, 128 updates each in blocks of 16, in turns
   (eager, graph, graph, eager): median ms per update and updates/s.
   The HalfCheetah learning preset (``dreamer_times_phase``): ``act``
   latency at batch 16 and 256, eval and collect; ``train_epoch`` at batch
   128, the eager loop against graph replays, 64 updates an arm in blocks
   of 16, in turns.
   The fused loop (``fused_times_phase``): env steps/s of each collect of
   4h (its second collect, graph replays only), the capture's seconds; the
   HalfCheetah preset's iterations (env steps/s, the collect alone,
   updates/s); the same for ``[4 rigid3d]``'s collects and presets.
   Under torch.profiler, in a process of its own (``profiled_phase``,
   ``python3 chip_smoke.py --profiled``, started here; the process of the
   other phases never starts the profiler): ten replays of the flagship's
   epoch (one sweep kernel and one graph launch each in the trace; device
   time, busy share, launches outside the graph), 5 ``train_step`` calls
   per variant (the sweep's share, host time per phase), ten replays and
   three eager updates of the HalfCheetah learning preset (no sweep
   kernel), one replayed env step of each collect of 4h (its kernels; one
   sweep kernel where the sweep acts, none in the HalfCheetah preset's
   step; the 3D collects' steps too) and one collect of each Pendulum run
   and of the Ant3D run (one sweep kernel an env step, the sweep's share
   of the device time, the busy share). A trace can lose events, so a
   session whose count of sweep kernels misses runs again (``traced``).
6. the kernel summary line, the card line, and the result line.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

FLAGSHIP_OBS, FLAGSHIP_ACT = 17, 6  # HalfCheetah-v4
# Flagship width (bench.py:235-238): batch 256, latent 32, hidden 128,
# 6 DiT blocks, K = 25 cosine.
FLAGSHIP = dict(batch=256, latent=32, hidden=128, layers=6, schedule=25)
HUMANOID_BATCHES = (256, 8)  # batched eval/collect; num_parallel_envs of the preset
# (kernel, name, batch, latent, hidden, layers, schedule length, sweep steps)
PARITY_SHAPES = [
    ("denoise_sweep_v1_f32", "flagship", 256, 32, 128, 6, 25, 25),
    # examples/configs/halfcheetah_state.yaml, full sweep and its collect sweep
    ("denoise_sweep_v1_f32", "halfcheetah_state", 256, 50, 256, 6, 100, 100),
    ("denoise_sweep_v1_f32", "halfcheetah_state_collect", 256, 50, 256, 6, 100, 50),
    ("denoise_sweep_v1_f32", "ragged", 37, 32, 128, 6, 25, 25),
    # examples/configs/humanoid_state.yaml, full sweep and its collect sweep
    ("denoise_sweep_v1_bf16", "humanoid_state", 256, 64, 256, 6, 50, 50),
    ("denoise_sweep_v1_bf16", "humanoid_state_collect", 256, 64, 256, 6, 50, 25),
    ("denoise_sweep_v1_bf16", "humanoid_ragged", 37, 64, 256, 6, 50, 50),
    ("denoise_sweep_v2_f32", "flagship", 256, 32, 128, 6, 25, 25),
    ("denoise_sweep_v2_f32", "humanoid_state", 256, 64, 256, 6, 50, 50),
    ("denoise_sweep_v2_bf16", "humanoid_state", 256, 64, 256, 6, 50, 50),
    # Added last, so the rows above keep their seeds (the row's index) and errors.
    ("denoise_sweep_v1_bf16", "humanoid_b8", 8, 64, 256, 6, 50, 50),
    ("denoise_sweep_v2_bf16", "humanoid_ragged", 37, 64, 256, 6, 50, 50),
    ("denoise_sweep_v2_bf16", "humanoid_b8", 8, 64, 256, 6, 50, 50),
    # two waves of 16-row clusters; K of examples/configs/humanoid3d_fused.yaml
    ("denoise_sweep_v1_bf16", "humanoid_b512", 512, 64, 256, 6, 50, 10),
    ("denoise_sweep_v2_bf16", "humanoid_b512", 512, 64, 256, 6, 50, 10),
    ("denoise_sweep_v1_f32", "flagship_b1", 1, 32, 128, 6, 25, 25),
    ("denoise_sweep_v2_f32", "humanoid_b8", 8, 64, 256, 6, 50, 50),
    # the flagship train step's belief sweep: observations and next observations, 2 x 256 rows
    ("denoise_sweep_v1_f32", "flagship_b512", 512, 32, 128, 6, 25, 25),
    # the config's default width (latent 128, hidden 512) in bfloat16: the streamed plan
    ("denoise_sweep_v1_bf16", "default", 8, 128, 512, 6, 100, 100),
    ("denoise_sweep_v2_bf16", "default_ragged", 37, 128, 512, 6, 100, 100),
    # hidden 96, padded to the kernels' 128
    ("denoise_sweep_v1_f32", "h96", 8, 128, 96, 6, 100, 100),
    ("denoise_sweep_v2_f32", "h96_ragged", 37, 128, 96, 6, 100, 100),
    # float32 streamed: hidden 300 padded to 320, one wave and two of clusters
    ("denoise_sweep_v1_f32", "h300", 256, 32, 300, 6, 25, 25),
    ("denoise_sweep_v2_f32", "h300_b512", 512, 32, 300, 6, 25, 10),
    # the HalfCheetah learning preset's width with use_ema_for_act (C4), B=16
    ("denoise_sweep_v1_f32", "dreamer_c4", 16, 32, 128, 6, 15, 15),
    # the fused collect (train_fused's defaults): Pendulum's 1024 envs, the
    # warm start's K=3, HopperPlanar's 512 envs, the eval's 64
    ("denoise_sweep_v1_f32", "fused_pendulum", 1024, 16, 64, 2, 10, 10),
    ("denoise_sweep_v1_f32", "fused_pendulum_warm", 1024, 16, 64, 2, 10, 3),
    ("denoise_sweep_v1_f32", "fused_hopper", 512, 16, 64, 2, 10, 10),
    ("denoise_sweep_v1_f32", "fused_eval", 64, 16, 64, 2, 10, 10),
    # the Ant3D collect (bench.py:1036-1089): 256 envs at train_fused's defaults
    ("denoise_sweep_v1_f32", "fused_ant3d", 256, 16, 64, 2, 10, 10),
    # halfcheetah_state_tuned.yaml's collect on HalfCheetahPlanar-v0: 64 envs, K=15
    ("denoise_sweep_v1_f32", "tuned_collect", 64, 32, 128, 6, 15, 15),
]
# The widths C1 found refused, at the config's 6 blocks. (latent, hidden,
# compute_dtype); batch 8, K=100 (the halfcheetah_state.yaml schedule; the
# default 1000 steps would only lengthen the CPU twin's run). Beyond the
# kernels' 48 MiB of trunk weights (the JAX core's fused-sweep rule) the card
# runs the plain sweep: the config's default (latent 128, hidden 512) and
# hidden 384 in float32. Within it the kernel runs: the default in bfloat16
# (streamed plan) and hidden 96 in float32 (padded to 128).
C1_STEPS = 100
C1_WIDTHS = {(128, 512, "float32"): "plain", (128, 384, "float32"): "plain",
             (128, 512, "bfloat16"): "kernel", (128, 96, "float32"): "kernel"}
# Train steps of the flagship path: stochastic-belief steps counted, and
# deterministic steps held against the CPU twin, per variant.
TRAIN_STEPS = {"v1": 5, "v2": 2}
# Card against CPU twin in one train update: the CPU parity tests' rule
# (tests/test_torch_train.py) for the losses, rtol 2e-4 / atol 2e-5, and
# the updated parameters, rtol 2e-4 / atol 2e-5 plus 2 lr where the two
# gradients' signs differ (Adam's first step moves an element by about
# lr sign(g)), with fewer than 1 in 100 elements of a partition under that
# rule. The gradients, as Adam's first moments (0.1 g), are held by their
# relative L2 distance per partition rather than elementwise: at B=256 a few
# of the relu/clamp kinks among some 10^6 activations fall on the other side
# between two orders of float32 summation, so an element here and there
# differs by more than 2e-4 (on an NVIDIA H100: up to 1.1x that for the
# policy, relative L2 3.2e-5): MOMENT_REL_L2. The MINE head's gradient at
# these latents (|z| up to ~10) is only as accurate as float32 makes it,
# relative L2 5.1e-3 from float64 on the CPU (tools/mine_conditioning.py),
# and 1.7e-3 (v1) and 1.4e-4 (v2) card against CPU on an H100: MINE_REL_L2.
# A control step with TF32 products on the card must fail it.
TRAIN_RTOL, TRAIN_ATOL, MOMENT_REL_L2, MINE_REL_L2 = 2e-4, 2e-5, 1e-4, 5e-3
TRAIN_TIMED, TRAIN_WARMUP = 10, 3
# The replay ring and train_epoch: TrainingConfig.buffer_size transitions at
# the flagship's shapes, filled in blocks with 120,000 seeded transitions so
# that it wraps once; graph replays held against the eager loop over steps 0-9
# (MINE at 0 and 5) per variant; one profiled epoch of 10 replays; a chunked
# epoch of 300 updates (chunks of 150 and 150 at epoch_chunk_updates 256); the
# timed arms, 128 updates each in blocks of 16, in turns.
RING_CAPACITY, RING_FILL, RING_BLOCK = 100_000, 120_000, 10_000
EPOCH_COMPARED, EPOCH_PROFILED, EPOCH_CHUNKED = 10, 10, 300
EPOCH_TIMED, EPOCH_BLOCK = 128, 16
# The learning presets (examples/configs/*_state_dreamer.yaml) at their
# published widths: latent 32, hidden 128, 6 DiT blocks, K=15, batch 128,
# 5 dynamics members, EFE horizon 5 x 10 trajectories; the environments'
# (observation, action) dimensions: HalfCheetah-v4, Hopper-v4 and
# Walker2d-v4. Steps 0-9 graph against eager per preset, and Hopper again with the anchor's
# warm-up cut to 5 steps; acting at num_parallel_envs (16) and 256; the
# timed epoch 64 updates an arm in blocks of 16.
DREAMER_SHAPES = {"halfcheetah": (FLAGSHIP_OBS, FLAGSHIP_ACT), "hopper": (11, 3),
                  "walker2d": (17, 6)}
DREAMER_GATE_STEP = 5
DREAMER_ACT_BATCHES = (16, 256)
DREAMER_TIMED = 64
# The fused collect+train loop (train_fused, python -m
# active_inference_diffusion_torch.train_fused): bench.py's shapes. Pendulum-v1
# at the entry point's flag defaults (latent 16, hidden 64, 2 blocks, K=10,
# bench.py:740-841), 1024 envs x 64 steps, then warm starts at K=3; its eval,
# 64 envs x one 200-step episode; HopperPlanar-v0 at 512 x 32 (bench.py:860-890)
# and Walker2dPlanar-v0 at 64 x 16 with the same widths;
# halfcheetah_planar_fused.yaml at its published widths in the README's loop
# (64 envs, 16 steps and 64 train_epoch updates an iteration), 3 iterations
# from an empty ring and an eval of 64 envs cut to 100 of its 1000 steps.
# Graph replays against the eager loop over steps 0-3 (the same kernels: equal
# up to rounding); the card against the CPU twin over steps 0-1: the sweep's
# SWEEP_TOL carried through the policy head, the exploration noise and one or
# two env steps of the dynamics.
FUSED_PENDULUM, FUSED_WARM_STEPS, FUSED_EVAL_ENVS = (1024, 64), 3, 64
FUSED_HOPPER, FUSED_WALKER = (512, 32), (64, 16)
FUSED_CHEETAH = dict(envs=64, steps=16, updates=64, iterations=3, eval_envs=64, eval_steps=100)
FUSED_COLLECTS = ("Pendulum-v1 sweep, K=10", f"Pendulum-v1 warm start, K={FUSED_WARM_STEPS}",
                  "HopperPlanar-v0", "Walker2dPlanar-v0")
FUSED_GRAPH_STEPS, FUSED_TWIN_STEPS = 4, 2
FUSED_GRAPH_TOL, FUSED_TWIN_TOL = (1e-6, 1e-6), (1e-3, 1e-3)
# The 3D engine (envs/rigid3d.py) in the fused loop: the Ant3D collect at
# bench.py:1036-1089's shape (256 envs x 16 steps, train_fused's defaults:
# latent 16, hidden 64, 2 blocks, K=10); Humanoid3D-v0 and
# HumanoidStandup3D-v0, 64 envs x 8 steps with the same sweep policy;
# humanoid3d_fused.yaml at its published widths (latent 64, hidden 256, 6
# blocks, K=10, batch 128, 5 members, posterior acting, bf16 compute_dtype) in
# the README's loop (64 envs x 16 steps and 64 train_epoch updates an
# iteration), 2 iterations from an empty ring, and one of ant3d_fused.yaml;
# each preset's eval of 16 envs cut to 100 of its 1000 steps for chip time.
# The CPU twin of the Humanoid family is held at rtol / atol 1e-2 rather than
# 4h's 1e-3: their observation carries cfrc_ext, the penalty contacts'
# wrenches, whose stiffness turns float32 rounding of the state into ~1e-3
# of the force after one step (tests/test_torch_rigid3d.py, float32 against
# float64), and card and CPU round differently (1.7e-3 relative for
# HumanoidStandup3D at 64 envs over steps 0-1 on an H100); that float32 check
# passes on the states the collect visits, and on seeded random actions C5 reads
# up to 4.4x the 1e-2. So their env steps are also held in float64 at
# RIGID3D_F64_TOL, card against CPU from the first collect's own start states and
# actions over its first C5_STEPS steps, where the two compute the same function:
# that check tells a fault from rounding; the float32 one is reported beside it.
RIGID3D_COLLECTS = {"Ant3D-v0": (256, 16), "Humanoid3D-v0": (64, 8),
                    "HumanoidStandup3D-v0": (64, 8)}
RIGID3D_TWIN_TOL = {"Ant3D-v0": FUSED_TWIN_TOL, "Humanoid3D-v0": (1e-2, 1e-2),
                    "HumanoidStandup3D-v0": (1e-2, 1e-2)}
RIGID3D_F64_TOL = (1e-9, 1e-9)
RIGID3D_PRESETS = {
    "humanoid3d_fused": dict(envs=64, steps=16, updates=64, iterations=2, eval_envs=16,
                             eval_steps=100),
    "ant3d_fused": dict(envs=64, steps=16, updates=64, iterations=1, eval_envs=16,
                        eval_steps=100),
}
# [4 ground]: examples/configs/halfcheetah_state_tuned.yaml (grounded beliefs) at its
# published widths (latent 32, hidden 128, 6 blocks, K=15, batch 128, so the
# differentiated sweep covers 2 x 128 rows) and HalfCheetah-v4's dimensions: one
# update against the CPU twin, steps 0-9 as graph replays against the eager loop,
# a copy with policy_lr_decay_steps=TUNED_DECAY_STEPS over steps 0-5 (its decay ends
# at step 4), rate and parameters step by step; then train_fused on
# HalfCheetahPlanar-v0, whose collect launches the v1-f32 kernel at B=64, K=15, in
# the README's loop shape for TUNED_FUSED["iterations"] iterations. The C5 check:
# the Humanoid family's env steps in float64 and float32 on the card against the
# CPU on the same states and actions, C5_ENVS envs over C5_STEPS steps, at
# C5_TOL (float64) and at 4h's 1e-3 (float32, reported).
TUNED = "halfcheetah_state_tuned"
TUNED_DECAY_STEPS, TUNED_DECAY_COMPARED = 4, 6
TUNED_FUSED = dict(envs=64, steps=16, updates=64, iterations=2)
GROUND_TIMED, GROUND_PROFILED = 32, 3  # its timed arms (eager, graphs); profiled replays
C5_ENVS, C5_STEPS, C5_TOL = 16, 4, (1e-9, 1e-9)
# [4 resume]: train_fused with the tuned preset on Pendulum-v1 (its sweep acts at
# K=15 in the collect and the eval), 2 iterations saving best and final with the
# ring, a resume of final for one iteration, and a resume without the ring that
# refills RESUME_REFILL env steps.
RESUME_LOOP = dict(envs=64, steps=16, updates=8, eval_envs=16)
RESUME_REFILL = 2048
# Kernel vs plain sweep, elementwise |kernel - plain| <= atol + rtol |plain|.
# float32: another summation order, compounded over up to 100 dependent
# steps of 6 blocks. bfloat16 weights: the same rounding sites on both
# sides, but a one-ulp float32 difference from the other summation order
# can put an activation on the other side of a bfloat16 rounding boundary
# (a 2**-8 relative step), and the flip compounds over the K steps.
SWEEP_TOL = {torch.float32: (1e-3, 1e-4), torch.bfloat16: (3e-2, 3e-2)}
# Eval actions (tanh of the policy mean, clipped) of the card against the
# CPU, per weight type, for the same reasons; the policy head and the tanh
# damp the latents' differences.
ACT_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
TIMED_CALLS, WARMUP_CALLS = 25, 3
# Published H100 SXM peaks (NVIDIA data sheet; dense): HBM bytes/s, and
# FLOP/s per operand type. float32: products accurate to float32 on the tensor
# cores, three TF32 products (495 TFLOP/s) per float32 one, as the kernels take
# them (3xTF32); above the 67 TFLOP/s of float32 outside the tensor cores.
# bfloat16: the bf16 tensor cores.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
# Phase 5's profiled replays run in a process of their own (profiled_phase).
PROFILED_FLAG, PROFILED_TIMEOUT_S, PROFILE_TRIES = "--profiled", 300, 3
REPLACES = {
    "denoise_sweep_v1_f32": "active_inference_diffusion_tpu/ops/denoise.py:159",
    "denoise_sweep_v1_bf16": "active_inference_diffusion_tpu/ops/denoise.py:159",
    "denoise_sweep_v2_f32": "active_inference_diffusion_tpu/ops/denoise.py:369",
    "denoise_sweep_v2_bf16": "active_inference_diffusion_tpu/ops/denoise.py:369",
}


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
    vectors, 1 for scalars); output_multiplier 1.0, so the score head is not
    near zero."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            fan_in = p.shape[-1] if p.dim() >= 2 else p.numel()
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in**0.5)
            if name.endswith("output_multiplier"):
                p.fill_(1.0)


def flagship_config():
    """The flagship configuration (bench.py:235-238, :282-295): HalfCheetah-v4,
    batch 256, latent 32, hidden 128, 6 DiT blocks, K=25 cosine, kl_weight
    0.5, every other flag at the config's default."""
    from active_inference_diffusion_torch import ActiveInferenceConfig, DiffusionConfig

    return ActiveInferenceConfig(
        observation_dim=FLAGSHIP_OBS, action_dim=FLAGSHIP_ACT, latent_dim=FLAGSHIP["latent"],
        hidden_dim=FLAGSHIP["hidden"], score_num_layers=FLAGSHIP["layers"],
        batch_size=FLAGSHIP["batch"], kl_weight=0.5,
        diffusion=DiffusionConfig(num_diffusion_steps=FLAGSHIP["schedule"], beta_schedule="cosine"),
    )


def flagship_agent(device, train: bool = False):
    """The flagship agent on ``device``, 20 collect steps on its 25-step
    schedule (as the upstream HalfCheetah entry point runs). Acting: every
    parameter ``randomize``d (seed 100). Training (``train``): the Flax
    initialisers from seed 300, then the score network ``randomize``d (seed
    301), so its head is not zero."""
    from active_inference_diffusion_torch import DiffusionStateAgent, TrainingConfig

    agent = DiffusionStateAgent(FLAGSHIP_OBS, FLAGSHIP_ACT, flagship_config(),
                                TrainingConfig(collect_diffusion_steps=20), device=device)
    if train:
        agent.core.init_params(torch.Generator(device=device).manual_seed(300))
        randomize(agent.core.score_network, seed=301)
    else:
        randomize(agent.core, seed=100)
    return agent


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


def graph_ms(fn, calls: int) -> float:
    """Median milliseconds of ``fn`` captured once into a CUDA graph and
    replayed: its kernels without the host's launch cost."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    from active_inference_diffusion_torch.agents.graphs import collector_off

    graph = torch.cuda.CUDAGraph()
    with collector_off(), torch.cuda.graph(graph):
        fn()
    cuda_ms(graph.replay, WARMUP_CALLS)
    return statistics.median(cuda_ms(graph.replay, calls))


def sweep_inputs(kernel, batch, latent, hidden, layers, schedule_len, steps, seed,
                 obs_dim=FLAGSHIP_OBS):
    """A seeded score network (``randomize``) packed for ``kernel``, and a
    sweep's inputs on the card: the kernel's wrapper and its arguments."""
    from active_inference_diffusion_torch.core.schedules import make_schedule
    from active_inference_diffusion_torch.models.score_network import LatentScoreNetwork
    from active_inference_diffusion_torch.ops.denoise import (
        KERNELS,
        fused_denoise_sweep,
        fused_denoise_sweep_v2,
        packed_trunk_weights,
    )

    dev = torch.device("cuda")
    variant, dtype, _, _ = KERNELS[kernel]
    net = LatentScoreNetwork(latent, obs_dim, hidden_dim=hidden, num_layers=layers).to(dev)
    randomize(net, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z0 = torch.randn((batch, latent), generator=gen, device=dev)
    obs = torch.randn((batch, obs_dim), generator=gen, device=dev)
    with torch.no_grad():
        obs_emb = net.obs_embedding(obs).contiguous()
        t = torch.arange(steps - 1, -1, -1, device=dev, dtype=torch.float32)
        t_embs = net.time_embedding(t, continuous=False).contiguous()
    seed_t = torch.tensor(1234 + seed, dtype=torch.int64, device=dev)
    schedule = make_schedule(schedule_len, "cosine", device=dev)
    packed = packed_trunk_weights(net, variant, dtype)
    wrapper = {"v1": fused_denoise_sweep, "v2": fused_denoise_sweep_v2}[variant]
    return wrapper, (schedule, packed, z0, obs_emb, t_embs, seed_t, steps, layers)


def plain_bf16_products(args):
    """The stochastic plain sweep, as ``denoise_sweep_reference`` takes it,
    with every product one cuBLAS bf16 x bf16 product of the rounded
    activation and the stored bf16 weight, summed in float32 with a float32
    output (``torch.mm(..., out_dtype=)``): a tighter timing yardstick for
    the bf16 kernels, measured here only; the port never calls it."""
    import torch.nn.functional as F

    from active_inference_diffusion_torch.models.common import LN_EPS
    from active_inference_diffusion_torch.ops.denoise import philox_normal, sweep_coefficients

    schedule, packed, z0, obs_emb, t_embs, seed, steps, layers = args
    views, h_dim = packed.views(), packed.hidden_dim
    coeffs = sweep_coefficients(schedule, steps, False)
    rows = torch.arange(z0.shape[0], device=z0.device)[:, None]
    cols = torch.arange(z0.shape[1], device=z0.device)[None, :]

    def mm(x, name, l=None, bias=None):
        w = views[name] if l is None else views[name][l]
        y = torch.mm(x.to(torch.bfloat16), w, out_dtype=torch.float32)
        return y if bias is None else y + (views[bias] if l is None else views[bias][l])

    def adaln(x, mod):
        return F.layer_norm(x, (h_dim,), eps=LN_EPS) * (1.0 + mod[:, :h_dim]) + mod[:, h_dim:]

    def mlp(h, l, mod):
        return h + mm(F.gelu(mm(adaln(h, mod), "f1_w", l, "f1_b"), approximate="tanh"),
                      "f2_w", l, "f2_b")

    def trunk(z, sc):
        h = mm(z, "latent_proj_w", bias="latent_proj_b")
        if packed.variant == "v1":
            for l in range(layers):
                x1 = adaln(h, mm(sc, "mod1_w", l, "mod1_b"))
                h = h + mm(mm(x1, "v_w", l, "v_b"), "o_w", l, "o_b")
                h = mlp(h, l, mm(sc, "mod2_w", l, "mod2_b"))
            return adaln(h, mm(sc, "modf_w", bias="modf_b"))
        mods = mm(sc, "mod_w", bias="mod_b")
        for l in range(layers):
            base = 4 * h_dim * l
            h = h + mm(adaln(h, mods[:, base : base + 2 * h_dim]), "vo_w", l, "vo_b")
            h = mlp(h, l, mods[:, base + 2 * h_dim : base + 4 * h_dim])
        return adaln(h, mods[:, 4 * h_dim * layers :])

    z = z0
    for i in range(steps):
        sc = F.silu(obs_emb + t_embs[i][None, :])
        score = torch.clamp(mm(F.silu(mm(trunk(z, sc), "out1_w", bias="out1_b")), "out2_w"),
                            -10.0, 10.0) * packed.output_multiplier
        s1, s2, c1, c2, sd, mask = coeffs[i, :6]
        z_next = c1 * ((z + s1 * score) * s2) + c2 * z
        if i < steps - 1:
            z_next = z_next + mask * sd * philox_normal(seed, rows, i, cols)
        z = z_next
    return z


def parity_rows(kernels=None):
    """Each row of ``PARITY_SHAPES`` (of ``kernels``, default all), its seed
    the row's index, swept by the kernel and by the plain version,
    deterministic and stochastic: yields one dict per sweep with max |err|,
    max |plain| and err/tol at ``SWEEP_TOL``. Raises on output that is not
    finite or misshapen."""
    from active_inference_diffusion_torch.ops.denoise import denoise_sweep_reference

    for i, (kernel, name, batch, latent, hidden, layers, k_sched, steps) in enumerate(PARITY_SHAPES):
        if kernels is not None and kernel not in kernels:
            continue
        wrapper, args = sweep_inputs(kernel, batch, latent, hidden, layers, k_sched, steps, seed=i)
        rtol, atol = SWEEP_TOL[args[1].dtype]
        for deterministic in (True, False):
            got = wrapper(*args, deterministic=deterministic)
            want = denoise_sweep_reference(*args, deterministic=deterministic)
            torch.cuda.synchronize()
            if not (torch.isfinite(got).all() and got.shape == want.shape):
                raise RuntimeError(f"{kernel} {name}: kernel output not finite or misshapen")
            err = (got - want).abs()
            yield dict(kernel=kernel, row=name, batch=batch, latent=latent, hidden=hidden,
                       layers=layers, schedule=k_sched, steps=steps, deterministic=deterministic,
                       max_abs_err=float(err.max()), max_abs_plain=float(want.abs().max()),
                       err_over_tol=float((err / (atol + rtol * want.abs())).max()))


def twin_of(agent):
    """The same agent on the CPU; it shares the agent's config objects."""
    from active_inference_diffusion_torch import DiffusionStateAgent

    twin = DiffusionStateAgent(agent.observation_dim, agent.action_dim, agent.config,
                               agent.training_config, device="cpu")
    twin.core.load_state_dict(agent.core.state_dict())
    return twin


def train_batch(batch: int, seed: int, device, obs_dim=FLAGSHIP_OBS, act_dim=FLAGSHIP_ACT
                ) -> dict:
    """A seeded replay batch at the given shapes (the flagship's by default)
    on ``device``."""
    rng = np.random.default_rng(seed)
    arrays = {
        "observations": rng.standard_normal((batch, obs_dim)),
        "next_observations": rng.standard_normal((batch, obs_dim)),
        "actions": np.tanh(rng.standard_normal((batch, act_dim))),
        "rewards": rng.standard_normal(batch),
        "dones": (rng.random(batch) < 0.05).astype(np.float32),
    }
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}


def state_fields(state) -> dict:
    """The train state's tensors beside the optimizers, by name: the EMAs
    (score, slow critic, policy), the return scale, log_alpha, time
    importance, MINE running mean and reward normaliser."""
    fields = {f"score EMA {k}": v for k, v in state.ema_score.items()}
    fields.update({f"slow critic {k}": v for k, v in state.target_value.items()})
    fields.update({f"EMA policy {k}": v for k, v in (state.ema_policy or {}).items()})
    norm = state.reward_norm
    fields.update({"return scale": state.return_scale, "log_alpha": state.log_alpha,
                   "time importance": state.time_importance,
                   "MINE running mean": state.epistemic_running_mean,
                   "reward mean": norm.mean, "reward var": norm.var, "reward count": norm.count})
    return fields


def compare_train_steps(state, metrics, twin_state, twin_metrics) -> dict:
    """One train update on the card against the same update of its twin
    (the CPU twin, or another agent on the card), both from fresh states (so
    g = first moment / 0.1; after more updates the moments are compared as
    they stand): the worst err/tol of the metrics and of the state's fields
    (``state_fields``); per partition the relative L2 distance of its
    first moments, the worst err/tol of its parameters, and the elements
    under the sign rule with the partition's size, by the rule above."""
    def ratio(got, want, atol):
        return float(((got - want).abs() / (atol + TRAIN_RTOL * want.abs())).max())

    twin_fields = state_fields(twin_state)
    out = {"metrics": max(ratio(metrics[k].cpu(), v.cpu(), TRAIN_ATOL)
                          for k, v in twin_metrics.items()),
           "state": max(ratio(v.detach().cpu(), twin_fields[k].detach().cpu(), TRAIN_ATOL)
                        for k, v in state_fields(state).items())}
    for part, opt in state.optimizers.items():
        twin_opt = twin_state.optimizers[part]
        mus = [opt.adamw.state[p]["exp_avg"].cpu() for p in opt.params]
        twin_mus = [twin_opt.adamw.state[p]["exp_avg"].cpu() for p in twin_opt.params]
        flat, twin_flat = torch.cat([m.flatten() for m in mus]), torch.cat([m.flatten() for m in twin_mus])
        row = {"moments_rel_l2": float((flat - twin_flat).norm() / twin_flat.norm()),
               "params": 0.0, "sign_rule": 0, "elements": flat.numel()}
        lr = float(opt.adamw.param_groups[0]["lr"])  # a 0-d tensor where it decays
        for p, q, mu, twin_mu in zip(opt.params, twin_opt.params, mus, twin_mus):
            q = q.detach().cpu()
            slack = 2 * lr * (torch.sign(mu) != torch.sign(twin_mu)).float()
            row["sign_rule"] += int(slack.count_nonzero())
            bound = TRAIN_ATOL + TRAIN_RTOL * q.abs() + slack
            row["params"] = max(row["params"], float(((p.detach().cpu() - q).abs() / bound).max()))
        out[part] = row
    return out


def train_step_fails(worst: dict) -> list:
    """The checks of ``compare_train_steps``' result that failed."""
    bad = [name for name in ("metrics", "state") if worst[name] > 1.0]
    for part, row in worst.items():
        if part in ("metrics", "state"):
            continue
        limit = MINE_REL_L2 if part == "epistemic" else MOMENT_REL_L2
        bad += [f"{part} moments"] * (row["moments_rel_l2"] > limit)
        bad += [f"{part} parameters"] * (row["params"] > 1.0)
        bad += [f"{part} sign rule"] * (row["sign_rule"] * 100 >= row["elements"])
    return bad


def describe_train_comparison(worst: dict) -> str:
    return f"err/tol metrics {worst['metrics']:.3f}, state fields {worst['state']:.3f}; per " \
        "partition (first moments' relative L2, parameters err/tol, elements under the sign " \
        "rule of the partition's): " + \
        "; ".join(f"{part} {row['moments_rel_l2']:.3e}, {row['params']:.3f}, "
                  f"{row['sign_rule']} of {row['elements']}"
                  for part, row in worst.items() if part not in ("metrics", "state"))


def traced(fn, calls: int, names: str = "denoise_sweep", want=None) -> tuple:
    """``calls`` runs of ``fn`` in one torch.profiler session: (host ms per
    call, the session's events). A trace that holds no device event at all
    saw nothing of what ran (one session in 56 on an H100), and the trace of
    a graph replay can lose a few of its kernels (one replayed env step of
    the same graph read 170, 171 and 172 kernels in three runs; one
    64-step collect read 63 sweep kernels): such a session, or, where
    ``want`` is given, one whose trace holds another number of kernels named
    ``names``, is run again, ``PROFILE_TRIES`` times at most in all. The
    last session with device events is returned if no session held
    ``want``, for the caller's check to refuse."""
    from torch.profiler import ProfilerActivity, profile

    last = None
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / calls
        events = prof.events()
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith("train_step/")]
        if not device:
            log("[5 profiled] the profiler's trace held no device event; the session again")
            continue
        last = host, events
        seen = sum(names in e.name for e in device)
        if want is None or seen == want:
            return last
        log(f"[5 profiled] {seen} kernels named {names} in the trace, expected {want}, of "
            f"{len(device)} device events; the session again")
    if last is None:
        raise RuntimeError(f"no device event in the profiler's trace in {PROFILE_TRIES} sessions")
    return last


def profile_ms(fn, calls: int, names: str, want=None) -> dict:
    """``calls`` runs of ``fn`` under torch.profiler (``traced``, which
    runs the session again where ``want`` kernels are not seen): host ms
    per call, the device ms per call summed over kernels, the share of it
    spent in kernels whose name holds ``names`` and how many such kernels
    the trace holds, the kernel count, and the host ms per call of each
    ``train_step/<phase>`` range."""
    host, events = traced(fn, calls, names, want)
    # the phases' ranges appear twice: on the host, and as annotations on the device's timeline
    ranges = [e for e in events if e.name.startswith("train_step/")]
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("train_step/")]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls
    matched = [e for e in kernels if names in e.name]
    named = sum(e.time_range.elapsed_us() for e in matched) / 1e3 / calls
    phases: dict = {}
    for e in ranges:
        if e.device_type == torch.autograd.DeviceType.CPU:
            key = e.name.split("/", 1)[1]
            phases[key] = phases.get(key, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
    return dict(host_ms=host, device_ms=device, named_ms=named, named_kernels=len(matched),
                kernels_per_call=len(kernels) / calls, phases_host_ms=phases)


def fill_ring(dev, seed: int = 320, obs_dim=FLAGSHIP_OBS, act_dim=FLAGSHIP_ACT):
    """A ``DeviceReplayBuffer`` of ``RING_CAPACITY`` transitions at the
    given shapes (the flagship's by default), filled with ``RING_FILL``
    seeded ones in blocks of ``RING_BLOCK``, and a plain numpy model of the
    same ring; returns the buffer and a description of the check. Raises
    where pos, size or a slot written on the second pass differ from the
    model's."""
    from active_inference_diffusion_torch.data.replay import DeviceReplayBuffer

    rng = np.random.default_rng(seed)
    fields = {
        "observations": rng.standard_normal((RING_FILL, obs_dim), dtype=np.float32),
        "actions": np.tanh(rng.standard_normal((RING_FILL, act_dim), dtype=np.float32)),
        "rewards": rng.standard_normal(RING_FILL, dtype=np.float32),
        "next_observations": rng.standard_normal((RING_FILL, obs_dim), dtype=np.float32),
        "dones": rng.random(RING_FILL) < 0.05,
    }
    ring = DeviceReplayBuffer(RING_CAPACITY, (obs_dim,), act_dim, device=dev)
    model = {k: np.zeros((RING_CAPACITY,) + v.shape[1:], v.dtype) for k, v in fields.items()}
    pos = size = 0
    for start in range(0, RING_FILL, RING_BLOCK):
        block = {k: v[start : start + RING_BLOCK] for k, v in fields.items()}
        ring.add_batch(*block.values())
        for k, v in block.items():
            model[k][(pos + np.arange(RING_BLOCK)) % RING_CAPACITY] = v
        pos, size = (pos + RING_BLOCK) % RING_CAPACITY, min(size + RING_BLOCK, RING_CAPACITY)
    st = ring.state
    got = (int(st.pos), int(st.size), st.host_pos, st.host_size, len(ring))
    if got != (pos, size, pos, size, size):
        raise RuntimeError(f"ring: pos, size, host mirrors, len {got}, the model's {pos}, {size}")
    slot = 5  # written by transition RING_CAPACITY + 5, on the second pass
    for k in fields:
        if not np.array_equal(getattr(st, k)[slot].cpu().numpy(), model[k][slot]):
            raise RuntimeError(f"ring: slot {slot} of {k} differs from the model's")
    if not np.array_equal(st.observations[slot].cpu().numpy(), fields["observations"][RING_CAPACITY + slot]):
        raise RuntimeError(f"ring: slot {slot} does not hold transition {RING_CAPACITY + slot}")
    return ring, (f"{RING_FILL} transitions in blocks of {RING_BLOCK} into {RING_CAPACITY}: pos "
                  f"{got[0]}, size {got[1]} (host mirrors {got[2]}, {got[3]}) as the model's; slot "
                  f"{slot} holds transition {RING_CAPACITY + slot} in every field")


def eager_updates(agent, state, ring_state, updates: int):
    """The eager loop of ``train_step_from_draws``, each update drawn as
    ``train_epoch`` draws it (ring indices, then the update's draws, from
    ``state.rng``): returns the state and every update's metrics."""
    from active_inference_diffusion_torch.data.replay import replay_sample

    out = []
    for _ in range(updates):
        indices, draws = agent.draw_update(state, ring_state, agent.config.batch_size)
        state, metrics = agent.train_step_from_draws(state, replay_sample(ring_state, indices),
                                                     draws)
        out.append(metrics)
    return state, out


def graph_updates(agent, state, ring_state, updates: int):
    """``updates`` calls of ``train_epoch`` of one update each (graph
    replays on the card): returns the state and every update's metrics."""
    out = []
    for _ in range(updates):
        state, metrics = agent.train_epoch(state, ring_state, 1)
        out.append(metrics)
    return state, out


def largest_difference(agent, state, metrics, twin, twin_state, twin_metrics) -> tuple:
    """The largest absolute difference between two trainings, and where:
    every update's metrics, the parameters, the optimizers' moments and the
    state's fields (``state_fields``)."""
    pairs = [(f"update {i} {k}", m[k], w[k])
             for i, (m, w) in enumerate(zip(metrics, twin_metrics)) for k in w]
    pairs += [(f"parameter {n}", p, q) for (n, p), q in
              zip(agent.core.named_parameters(), twin.core.parameters())]
    for part, opt in state.optimizers.items():
        for i, (p, q) in enumerate(zip(opt.params, twin_state.optimizers[part].params)):
            for name in ("exp_avg", "exp_avg_sq"):
                pairs.append((f"{part} {name} {i}", opt.adamw.state[p][name],
                              twin_state.optimizers[part].adamw.state[q][name]))
    twin_fields = state_fields(twin_state)
    pairs += [(k, v, twin_fields[k]) for k, v in state_fields(state).items()]
    diffs = [(float((a.detach() - b.detach()).abs().max()), where) for where, a, b in pairs]
    return max(diffs)


def profile_epoch(agent, state, ring_state, updates: int, sweeps: int) -> tuple:
    """One ``train_epoch`` of ``updates`` replays under torch.profiler
    (``traced``, again where the trace holds other than ``sweeps`` sweep
    kernels): the sweep kernels in the device trace, the graph launches,
    the kernels' launches counted in that session, the host's launches
    outside the graphs per update (kernels, copies and fills), the device ms
    per update summed over its kernels, the sweep's, and the host ms per
    update. Returns (state, that dict)."""
    from active_inference_diffusion_torch.ops.denoise import LAUNCHES

    metrics, launched = {}, 0

    def epoch():
        nonlocal state, metrics, launched
        before = sum(LAUNCHES.values())
        state, metrics = agent.train_epoch(state, ring_state, updates)
        launched = sum(LAUNCHES.values()) - before

    host, events = traced(epoch, 1, "denoise_sweep", sweeps)
    host /= updates
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    runtime = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    sweeps = [e for e in device if "denoise_sweep" in e.name]
    outside = sum(1 for n in runtime if ("LaunchKernel" in n or "Memcpy" in n or "Memset" in n)
                  and "Graph" not in n)
    return state, dict(
        sweep_kernels=len(sweeps), graph_launches=sum(1 for n in runtime if "GraphLaunch" in n),
        launches=launched,
        launches_outside=outside / updates, device_ops=len(device) / updates,
        device_ms=sum(e.time_range.elapsed_us() for e in device) / 1e3 / updates,
        sweep_ms=sum(e.time_range.elapsed_us() for e in sweeps) / 1e3 / updates,
        host_ms=host, metrics_finite=all(bool(torch.isfinite(v)) for v in metrics.values()))


def epoch_times(eager, eager_state, graph, graph_state, ring_state, updates=EPOCH_TIMED,
                block=EPOCH_BLOCK) -> tuple:
    """The eager loop against ``train_epoch`` in graphs, ``updates`` each in
    blocks of ``block`` (host clock, synchronised), in turns: eager, graph,
    graph, eager, half the updates a turn. Returns the two states and, per
    arm, the median ms per update over its blocks and updates/s over all
    its updates."""
    def eager_block():
        nonlocal eager_state
        eager_state, _ = eager_updates(eager, eager_state, ring_state, block)

    def graph_block():
        nonlocal graph_state
        graph_state, _ = graph.train_epoch(graph_state, ring_state, block)

    arms = {"eager": eager_block, "graph": graph_block}
    per_update = {arm: [] for arm in arms}
    for arm in ("eager", "graph", "graph", "eager"):
        per_update[arm] += [ms / block for ms in host_ms(arms[arm], updates // 2 // block)]
    out = {arm: dict(median_ms=statistics.median(v), updates_per_s=1e3 / statistics.mean(v),
                     updates=len(v) * block) for arm, v in per_update.items()}
    return eager_state, graph_state, out


def host_ms(fn, calls: int) -> list:
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def epoch_phase(dev, launches: dict) -> tuple:
    """Phase 4f: the ring and ``train_epoch`` at the flagship, per variant:
    the eager loop against graph replays, the profiled launches, the
    chunked epoch and ``act`` after the epoch (see ``main``). Adds the
    launches to ``launches``; returns the ring and, per variant, the
    (eager agent, its state, graph agent, its state) after it."""
    from active_inference_diffusion_torch.ops.denoise import (
        KERNELS,
        LAUNCHES,
        PLAIN_RUNS,
        kernel_name,
    )

    ring, described = fill_ring(dev)
    log(f"[4 epoch] ring: {described}")
    obs_act = np.random.default_rng(330).standard_normal((FLAGSHIP["batch"], FLAGSHIP_OBS))
    obs_act = obs_act.astype(np.float32)
    epoch_pairs = {}
    for variant in ("v1", "v2"):
        kernel = kernel_name(variant, torch.float32)
        pair = [flagship_agent(dev, train=True) for _ in range(2)]  # eager, graph: the same weights
        for agent in pair:
            agent.config.tpu.denoiser_kernel = variant
        eager, graph = pair
        states = [agent.new_train_state(305) for agent in pair]
        for name in KERNELS:
            LAUNCHES[name] = PLAIN_RUNS[name] = 0
        before_acts = [agent.act(obs_act, torch.Generator(device=dev).manual_seed(331),
                                 deterministic=True, collect=False) for agent in pair]
        eager_state, eager_metrics = eager_updates(eager, states[0], ring.state, EPOCH_COMPARED)
        torch.cuda.synchronize()
        eager_launches = LAUNCHES[kernel]
        graph_state, graph_metrics = graph_updates(graph, states[1], ring.state, EPOCH_COMPARED)
        torch.cuda.synchronize()
        captures = graph._epoch_graphs.captures
        graph_launches = LAUNCHES[kernel] - eager_launches
        counts = (dict(LAUNCHES), dict(PLAIN_RUNS))
        log(f"[4 epoch] flagship {variant}-f32 B={FLAGSHIP['batch']}: {EPOCH_COMPARED} updates "
            f"from step 0 eagerly, then as {EPOCH_COMPARED} train_epoch calls of one graph replay "
            f"each ({captures} graphs captured, each after one warm-up update): launches "
            f"{counts[0]} (eager {eager_launches - 2}, acts 2, graph epoch {graph_launches}), plain "
            f"runs {sum(counts[1].values())}")
        want = EPOCH_COMPARED + captures
        if (captures != 2 or graph_launches != want or eager_launches != EPOCH_COMPARED + 2
                or sum(LAUNCHES.values()) != LAUNCHES[kernel] or sum(counts[1].values())):
            raise RuntimeError(f"epoch {variant}: expected 2 captures and {want} launches of "
                               f"{kernel} in the graph epoch, {EPOCH_COMPARED} eager, no other")
        mines = [step for step, m in enumerate(graph_metrics) if float(m["epistemic_mi"]) != 0.0]
        if mines != [0, 5] or graph_state.step != EPOCH_COMPARED:
            raise RuntimeError(f"epoch {variant}: MINE at steps {mines}, step {graph_state.step}")
        worst = compare_train_steps(graph_state, graph_metrics[-1], eager_state, eager_metrics[-1])
        worst["metrics"] = max(
            float(((g[k] - w[k]).abs() / (TRAIN_ATOL + TRAIN_RTOL * w[k].abs())).max())
            for g, w in zip(graph_metrics, eager_metrics) for k in w)
        largest, where = largest_difference(graph, graph_state, graph_metrics, eager,
                                            eager_state, eager_metrics)
        log(f"[4 epoch] flagship {variant} graph replays vs eager loop over steps 0-"
            f"{EPOCH_COMPARED - 1}: largest difference {largest:.3e}, in {where} (over the "
            "metrics of every update, parameters, moments and state fields); "
            + describe_train_comparison(worst))
        failed = train_step_fails(worst)
        if failed:
            raise RuntimeError(f"epoch {variant}: the graph replays disagree with the eager "
                               f"loop: {failed}")
        # R2: act after graph epochs uses the replays' weights, not a pack cached before them
        acts = [agent.act(obs_act, torch.Generator(device=dev).manual_seed(331),
                          deterministic=True, collect=False) for agent in pair]
        act_err = float(np.abs(acts[0] - acts[1]).max())
        act_moved = float(np.abs(acts[1] - before_acts[1]).max())
        log(f"[4 epoch] flagship {variant} act after the graph epoch vs after the eager loop: "
            f"max|err| {act_err:.3e} (tol {ACT_ATOL[torch.float32]:g}); before them the two "
            f"agents' "
            f"actions differ by {float(np.abs(before_acts[0] - before_acts[1]).max()):.3e}; the "
            f"updates moved the actions by up to {act_moved:.3e}")
        if act_err > ACT_ATOL[torch.float32] or act_moved == 0.0:
            raise RuntimeError(f"epoch {variant}: act after the graph epoch differs from the "
                               "eager twin's, or the updates did not move it")
        launches[kernel] += sum(LAUNCHES.values())  # the acts included

        if variant == "v1":
            # a chunked epoch: 300 updates in chunks of 150 and 150
            from active_inference_diffusion_torch.agents.base import epoch_chunks

            chunks = epoch_chunks(EPOCH_CHUNKED, graph.training_config.epoch_chunk_updates)
            LAUNCHES[kernel] = 0
            total_before, step_before = graph.total_steps, graph_state.step
            t0 = time.perf_counter()
            graph_state, metrics = graph.train_epoch(graph_state, ring.state, EPOCH_CHUNKED)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
            log(f"[4 epoch] flagship v1 train_epoch of {EPOCH_CHUNKED} updates in chunks "
                f"{chunks}: {seconds:.3f} s, total_steps {total_before} -> {graph.total_steps}, "
                f"step {step_before} -> {graph_state.step}, launches {LAUNCHES[kernel]}, metrics "
                + json.dumps({k: round(float(v), 6) for k, v in metrics.items()}))
            if (bad or chunks != [150, 150] or graph.total_steps - total_before != EPOCH_CHUNKED
                    or graph_state.step - step_before != EPOCH_CHUNKED
                    or LAUNCHES[kernel] != EPOCH_CHUNKED):
                raise RuntimeError(f"epoch: the chunked epoch failed: non-finite {bad}")
            launches[kernel] += LAUNCHES[kernel]
        epoch_pairs[variant] = (eager, eager_state, graph, graph_state)
    return ring, epoch_pairs


def epoch_times_phase(ring, epoch_pairs: dict, card: str) -> None:
    """Phase 5, ``train_epoch``: the eager loop against graph replays at
    the flagship, v1, timed in turns (``profiled_phase`` profiles it)."""
    eager, eager_state, graph, graph_state = epoch_pairs["v1"]
    eager_state, graph_state, times = epoch_times(eager, eager_state, graph, graph_state,
                                                  ring.state)
    log(f"[5 times] train_epoch flagship v1-f32 B={FLAGSHIP['batch']}, {EPOCH_TIMED} updates an "
        f"arm in blocks of {EPOCH_BLOCK}, in turns (eager, graph, graph, eager): eager loop median "
        f"{times['eager']['median_ms']:.4f} ms an update, {times['eager']['updates_per_s']:.3f} "
        f"updates/s; graph replays median {times['graph']['median_ms']:.4f} ms an update, "
        f"{times['graph']['updates_per_s']:.3f} updates/s "
        f"({times['graph']['updates_per_s'] / times['eager']['updates_per_s']:.2f}x) | {card}")


def dreamer_agent(preset: str, device, **knobs):
    """examples/configs/<preset>_state_dreamer.yaml loaded from its file by
    the port's ``load_yaml_config``, ``knobs`` set on its config, at the
    environment's dimensions on ``device``: the Flax initialisers from seed
    400, then the score network ``randomize``d (seed 401)."""

    from active_inference_diffusion_torch import DiffusionStateAgent, load_yaml_config

    path = Path(__file__).resolve().parent / "examples" / "configs" / f"{preset}_state_dreamer.yaml"
    cfg, training, _ = load_yaml_config(str(path))
    for name, value in knobs.items():
        setattr(cfg, name, value)
    obs_dim, act_dim = DREAMER_SHAPES[preset]
    agent = DiffusionStateAgent(obs_dim, act_dim, cfg, training, device=device)
    agent.core.init_params(torch.Generator(device=device).manual_seed(400))
    randomize(agent.core.score_network, seed=401)
    return agent


def sweep_counts() -> tuple:
    from active_inference_diffusion_torch.ops.denoise import LAUNCHES, PLAIN_RUNS

    return sum(LAUNCHES.values()), sum(PLAIN_RUNS.values())


def dreamer_epoch_check(dev, label, preset, ring_state, one_epoch=False, **knobs):
    """``epoch_check`` of two trainers of the preset (``dreamer_agent``);
    no sweep may run. Returns (eager agent, its state, graph agent, its
    state, the kinds of update captured)."""
    return epoch_check("[4 dreamer]", label, lambda: dreamer_agent(preset, dev, **knobs),
                       ring_state, one_epoch)[:5]


def epoch_check(tag, label, make_agent, ring_state, one_epoch=False, plain_per_update=0):
    """Two trainers from ``make_agent`` (the same weights), steps 0-9 from
    the same state and draws: the eager loop of ``train_step_from_draws``,
    and ``train_epoch`` graph replays (ten calls of one update, or with
    ``one_epoch`` one call of ten). Held by the train check on the last
    update (or, in one epoch, on the updates' mean metrics) and the final
    state; no sweep kernel may launch, and each update runs
    ``plain_per_update`` plain sweeps (the grounded beliefs' differentiated
    sweep): the eager loop's, each replay's and each capture's warm-up.
    Returns (eager agent, its state, graph agent, its state, the kinds of
    update captured, the plain sweeps counted)."""
    pair = [make_agent() for _ in range(2)]
    eager, graph = pair
    states = [agent.new_train_state(405) for agent in pair]
    counts = sweep_counts()
    eager_state, eager_metrics = eager_updates(eager, states[0], ring_state, EPOCH_COMPARED)
    if one_epoch:
        graph_state, mean = graph.train_epoch(states[1], ring_state, EPOCH_COMPARED)
        graph_metrics = [mean]
        eager_metrics = [{k: torch.stack([m[k] for m in eager_metrics]).mean()
                          for k in eager_metrics[0]}]
    else:
        graph_state, graph_metrics = graph_updates(graph, states[1], ring_state, EPOCH_COMPARED)
        mines = [s for s, m in enumerate(eager_metrics) if float(m["epistemic_mi"]) != 0.0]
        if mines != [s for s in range(EPOCH_COMPARED) if s % eager.config.epistemic_update_every == 0]:
            raise RuntimeError(f"{label}: MINE at steps {mines}")
    torch.cuda.synchronize()
    kinds = sorted(graph._epoch_graphs.captured)
    launched, plain = (now - before for now, before in zip(sweep_counts(), counts))
    want_plain = plain_per_update * (2 * EPOCH_COMPARED + graph._epoch_graphs.captures)
    if launched or plain != want_plain or graph_state.step != EPOCH_COMPARED:
        raise RuntimeError(f"{label}: {launched} sweep launches and {plain} plain sweeps (expected "
                           f"0 and {want_plain}), or the graph epoch ended at step "
                           f"{graph_state.step}")
    worst = compare_train_steps(graph_state, graph_metrics[-1], eager_state, eager_metrics[-1])
    worst["metrics"] = max(
        float(((g[k] - w[k]).abs() / (TRAIN_ATOL + TRAIN_RTOL * w[k].abs())).max())
        for g, w in zip(graph_metrics, eager_metrics) for k in w)
    largest, where = largest_difference(graph, graph_state, graph_metrics, eager, eager_state,
                                        eager_metrics)
    log(f"{tag} {label}: steps 0-{EPOCH_COMPARED - 1} as "
        f"{'one train_epoch call' if one_epoch else f'{EPOCH_COMPARED} train_epoch calls'} of "
        f"graph replays vs the eager loop; kinds captured (MINE, anchor open) {kinds}; plain "
        f"sweeps {plain}, sweep launches {launched}; largest difference {largest:.3e}, in "
        f"{where} (over the metrics, parameters, moments and state fields); "
        + describe_train_comparison(worst))
    failed = train_step_fails(worst)
    if failed:
        raise RuntimeError(f"{label}: the graph replays disagree with the eager loop: {failed}")
    return eager, eager_state, graph, graph_state, kinds, plain


def dreamer_acting_errors(agent, state) -> dict:
    """Posterior acting on the card with ``state`` (its EMA policy where the
    preset acts with it) against the CPU twin on the same draws, at each of
    ``DREAMER_ACT_BATCHES``: ``act`` in eval and in collect mode (the
    policy's eps and the exploration noise replayed from the card's
    generator), ``act_warm`` (actions and latents), and the core's ``act``
    with ``compute_efe_info`` (the EFE over the ensemble). Returns the
    worst err/tol of each (actions at ``ACT_ATOL``, the EFE info at the
    train check's rtol/atol)."""
    from active_inference_diffusion_torch.models.policy import sample_action

    dev = agent.device
    twin = twin_of(agent)
    twin_state = twin.new_train_state(0)
    for field in ("ema_score", "target_value", "ema_policy"):
        if getattr(state, field) is not None:
            setattr(twin_state, field, {k: v.cpu() for k, v in getattr(state, field).items()})
    atol = ACT_ATOL[torch.float32]
    errs = {}
    for batch in DREAMER_ACT_BATCHES:
        obs = np.random.default_rng(batch).standard_normal((batch, agent.observation_dim))
        obs = obs.astype(np.float32)
        cpu_obs = torch.from_numpy(obs)
        for mode in ("eval", "collect"):
            gen = torch.Generator(device=dev).manual_seed(batch)
            actions = agent.act(obs, gen, deterministic=mode == "eval", collect=mode == "collect",
                                state=state)
            if actions.shape != (batch, agent.action_dim) or not np.isfinite(actions).all():
                raise RuntimeError(f"act returned {actions.shape}, or non-finite actions")
            gen = torch.Generator(device=dev).manual_seed(batch)
            start = agent.core.draw_start(batch, gen).to("cpu")
            if mode == "eval":
                want, _ = twin.act_from_start(cpu_obs, start, None, deterministic=True,
                                              state=twin_state)
            else:  # the policy's eps and the exploration noise, as act draws them
                eps = torch.randn(actions.shape, generator=gen, device=dev).cpu()
                noise = torch.randn(actions.shape, generator=gen, device=dev).cpu()
                with torch.no_grad(), twin.core.swapped(twin.acting_modules(twin_state)):
                    latent = twin.core.belief_latent(cpu_obs, start)
                    want, _ = sample_action(twin.core.apply_policy(latent), eps,
                                            squash=twin.core.policy_squash)
                want = torch.clamp(want + noise * twin.exploration_noise, -1.0, 1.0)
            errs[f"{mode} b={batch}"] = float(np.abs(want.numpy() - actions).max()) / atol
        # act_warm: the previous latents play no part in posterior acting
        gen = torch.Generator(device=dev).manual_seed(batch + 1)
        prev = torch.randn((batch, agent.core.latent_dim), generator=gen, device=dev)
        reset = np.arange(batch) % 3 == 0
        state_before = gen.get_state()
        actions, latents = agent.act_warm(obs, gen, prev, reset, deterministic=True, state=state)
        gen.set_state(state_before)
        fresh = torch.randn(prev.shape, generator=gen, device=dev).cpu()
        start = agent.core.draw_start(batch, gen).to("cpu")
        want, want_latents = twin.act_warm_from_start(
            cpu_obs, prev.cpu(), torch.from_numpy(reset), fresh, start, None, deterministic=True,
            state=twin_state)
        errs[f"act_warm b={batch}"] = max(
            float(np.abs(want.numpy() - actions).max()),
            float((want_latents - latents.cpu()).abs().max())) / atol
        # compute_efe_info, acting with the state's modules
        gen = torch.Generator(device=dev).manual_seed(batch + 2)
        with agent.core.swapped(agent.acting_modules(state)):
            actions, info = agent.core.act(gen, torch.from_numpy(obs).to(dev),
                                           deterministic=True, compute_efe_info=True)
        gen = torch.Generator(device=dev).manual_seed(batch + 2)
        start = agent.core.draw_start(batch, gen).to("cpu")
        efe = agent.core.draw_efe(batch, gen).to("cpu")
        with twin.core.swapped(twin.acting_modules(twin_state)):
            want, want_info = twin.core.act_from_start(cpu_obs, start, None, deterministic=True,
                                                       efe=efe)
        errs[f"efe_info b={batch}"] = max(
            [float((want - actions.cpu()).abs().max()) / atol]
            + [float(((info[k].cpu() - v).abs() / (TRAIN_ATOL + TRAIN_RTOL * v.abs())).max())
               for k, v in want_info.items()])
    return errs


def dreamer_phase(dev, launches: dict) -> dict:
    """Phase 4g: the learning presets on the card (see ``main``). Adds the
    sweep launches of the C4 check to ``launches``; returns the HalfCheetah
    preset's ring and its (eager agent, state, graph agent, state) for the
    timed phase."""
    from active_inference_diffusion_torch.ops.denoise import LAUNCHES

    out = {}
    for preset, (obs_dim, act_dim) in DREAMER_SHAPES.items():
        # a. one update with explicit draws, card against the CPU twin
        agent = dreamer_agent(preset, dev)
        twin = twin_of(agent)
        cfg = agent.config
        batch = train_batch(cfg.batch_size, 410, dev, obs_dim, act_dim)
        state, twin_state = agent.new_train_state(402), twin.new_train_state(402)
        draws = agent.draw_train(state, cfg.batch_size)
        counts = sweep_counts()
        state, metrics = agent.train_step_from_draws(state, batch, draws)
        torch.cuda.synchronize()
        if sweep_counts() != counts:
            raise RuntimeError(f"dreamer {preset}: the update ran a sweep")
        twin_state, twin_metrics = twin.train_step_from_draws(
            twin_state, {k: v.cpu() for k, v in batch.items()}, draws.to("cpu"))
        worst = compare_train_steps(state, metrics, twin_state, twin_metrics)
        log(f"[4 dreamer] {preset}_state_dreamer.yaml B={cfg.batch_size} D={cfg.latent_dim} "
            f"H={cfg.hidden_dim} L={cfg.score_num_layers} ensemble {cfg.num_dynamics_ensemble}, "
            f"{cfg.efe_horizon} x {cfg.num_efe_trajectories} imagined trajectories: one update "
            "(a MINE step) with explicit draws vs CPU twin, no sweep: "
            + describe_train_comparison(worst) + "; metrics "
            + json.dumps({k: round(float(v), 6) for k, v in metrics.items()}))
        failed = train_step_fails(worst)
        if failed:
            raise RuntimeError(f"dreamer {preset}: the card's update disagrees with the CPU "
                               f"twin: {failed}")

        # b. graph replays against the eager loop over steps 0-9
        ring, described = fill_ring(dev, 420, obs_dim, act_dim)
        log(f"[4 dreamer] {preset} ring: {described}")
        pair = dreamer_epoch_check(dev, f"{preset}_state_dreamer.yaml", preset, ring.state)
        if preset == "hopper":
            # c. the anchor's gate opens inside one train_epoch
            _, _, _, _, kinds = dreamer_epoch_check(
                dev, f"hopper_state_dreamer.yaml with policy_anchor_warmup_steps="
                f"{DREAMER_GATE_STEP} (this knob changed for this check only)", preset,
                ring.state, one_epoch=True, policy_anchor_warmup_steps=DREAMER_GATE_STEP)
            if kinds != [(False, False), (False, True), (True, False), (True, True)]:
                raise RuntimeError(f"hopper: the anchor's gate did not open inside the epoch: "
                                   f"kinds {kinds}")
        eager, eager_state, graph, graph_state, _ = pair
        if preset == "halfcheetah":
            out = dict(ring=ring, pair=pair)

        # d. posterior acting with the trained state, card against the CPU twin
        counts = sweep_counts()
        errs = dreamer_acting_errors(graph, graph_state)
        torch.cuda.synchronize()
        worst = max(errs.values())
        log(f"[4 dreamer] {preset} act_from_posterior with the trained state"
            f"{' (the EMA policy acts)' if graph_state.ema_policy is not None else ''} vs CPU "
            "twin: act eval and collect, act_warm, act with compute_efe_info (the EFE over the "
            "ensemble), err/tol " + json.dumps({k: float(f"{v:.3e}") for k, v in errs.items()})
            + f" (actions atol {ACT_ATOL[torch.float32]:g}; EFE info rtol {TRAIN_RTOL:g} atol "
            f"{TRAIN_ATOL:g}); sweeps launched {sweep_counts()[0] - counts[0]}")
        if worst > 1.0 or sweep_counts() != counts:
            raise RuntimeError(f"{preset}: posterior acting disagrees with the CPU twin, or ran "
                               "a sweep")

    # e. C4: use_ema_for_act acts with the score network's EMA (the sweep
    # kernel on the EMA's own pack), card against the CPU twin
    agent = dreamer_agent("halfcheetah", dev, act_from_posterior=False, use_ema_for_act=True)
    state = agent.new_train_state(406)
    ema_net = copy.deepcopy(agent.core.score_network)
    randomize(ema_net, seed=407)
    with torch.no_grad():
        for name, p in ema_net.named_parameters():
            state.ema_score[name].copy_(p)
    twin = twin_of(agent)
    twin_state = twin.new_train_state(406)
    twin_state.ema_score = {k: v.cpu() for k, v in state.ema_score.items()}
    obs = np.random.default_rng(408).standard_normal((16, DREAMER_SHAPES["halfcheetah"][0]))
    obs = obs.astype(np.float32)
    kernel = "denoise_sweep_v1_f32"
    before = LAUNCHES[kernel]
    gen = torch.Generator(device=dev).manual_seed(409)
    actions = agent.act(obs, gen, deterministic=True, collect=False, state=state)
    torch.cuda.synchronize()
    launched = LAUNCHES[kernel] - before
    start = agent.core.draw_start(16, torch.Generator(device=dev).manual_seed(409))
    want, _ = twin.act_from_start(torch.from_numpy(obs), start.to("cpu"), None,
                                  deterministic=True, state=twin_state)
    live, _ = twin.core.act_from_start(torch.from_numpy(obs), start.to("cpu"), None,
                                       deterministic=True)
    err = float(np.abs(want.numpy() - actions).max())
    moved = float(np.abs(live.numpy() - actions).max())
    log(f"[4 dreamer] C4: halfcheetah_state_dreamer.yaml with act_from_posterior off and "
        f"use_ema_for_act on, K={agent.config.diffusion.num_diffusion_steps}, B=16: act with the "
        f"state's score EMA, {launched} {kernel} launch, vs CPU twin max|err| {err:.3e} (tol "
        f"{ACT_ATOL[torch.float32]:g}); the live network's actions differ by {moved:.3e}")
    if launched != 1 or err > ACT_ATOL[torch.float32] or moved <= ACT_ATOL[torch.float32]:
        raise RuntimeError("C4: acting with the score EMA failed")
    launches[kernel] += launched
    return out


def dreamer_times_phase(dreamer: dict, card: str) -> None:
    """Phase 5, the HalfCheetah learning preset: ``act`` latency at 16 and
    256; ``train_epoch``, the eager loop against graph replays in turns
    (``profiled_phase`` profiles it)."""
    ring = dreamer["ring"]
    eager, eager_state, graph, graph_state, _ = dreamer["pair"]
    obs_dim = DREAMER_SHAPES["halfcheetah"][0]
    gen = torch.Generator(device=graph.device).manual_seed(0)
    for batch in DREAMER_ACT_BATCHES:
        obs = np.random.default_rng(batch).standard_normal((batch, obs_dim)).astype(np.float32)
        for mode in ("eval", "collect"):
            def call():
                graph.act(obs, gen, deterministic=mode == "eval", collect=mode == "collect",
                          state=graph_state)

            for _ in range(WARMUP_CALLS):
                call()
            act_ms = statistics.median(host_ms(call, TIMED_CALLS))
            log(f"[5 times] act latency halfcheetah_state_dreamer b={batch} {mode} "
                f"(act_from_posterior): median {act_ms:.4f} ms over {TIMED_CALLS} calls | {card}")
    batch = graph.config.batch_size
    eager_state, graph_state, times = epoch_times(eager, eager_state, graph, graph_state,
                                                  ring.state, updates=DREAMER_TIMED)
    log(f"[5 times] train_epoch halfcheetah_state_dreamer B={batch}, {DREAMER_TIMED} updates an "
        f"arm in blocks of {EPOCH_BLOCK}, in turns (eager, graph, graph, eager): eager loop "
        f"median {times['eager']['median_ms']:.4f} ms an update, "
        f"{times['eager']['updates_per_s']:.3f} updates/s; graph replays median "
        f"{times['graph']['median_ms']:.4f} ms an update, {times['graph']['updates_per_s']:.3f} "
        f"updates/s ({times['graph']['updates_per_s'] / times['eager']['updates_per_s']:.2f}x) "
        f"| {card}")



# -- 4h. the fused collect+train loop (train_fused) ---------------------------


def fused_run(*argv, seed: int = 500):
    """``train_fused.build_run`` on the card for ``argv`` (the entry
    point's own set-up), the Flax initialisers from ``seed``, then the score
    network ``randomize``d (seed + 1) and a fresh train state."""
    from active_inference_diffusion_torch import train_fused

    run = train_fused.build_run(train_fused.parse_args(
        ["--device", "cuda", "--seed", str(seed), *argv]))
    randomize(run.agent.core.score_network, seed=seed + 1)
    run.state = run.agent.new_train_state(seed + 2)
    return run


def _cpu_collect_draws(draws):
    from active_inference_diffusion_torch.core.active_inference import tree_to

    return draws._replace(steps=[tree_to(step, "cpu") for step in draws.steps])


def _twin_policy(run, twin, env):
    """The run's collect policy rebuilt on the CPU twin's core and env."""
    from active_inference_diffusion_torch.envs import device_envs as de

    cfg, args = run.agent.config, run.args
    if args.warm_start_steps:
        inner = de.make_warm_rollout_policy(twin.core, env, num_steps=args.warm_start_steps,
                                            deterministic_beliefs=cfg.deterministic_beliefs)
    else:
        inner = de.make_rollout_policy(twin.core, env, act_from_posterior=cfg.act_from_posterior,
                                       deterministic_beliefs=cfg.deterministic_beliefs)
    return de.ExplorationNoise(inner, env, run.collector.policy.eps.cpu())


def transitions_err(got, want, steps: int, rtol: float, atol: float) -> float:
    """The largest |got - want| / (atol + rtol |want|) over the first
    ``steps`` steps of two ``Transitions``; inf where a done differs."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g[:steps].cpu(), w[:steps].cpu()
        if g.dtype == torch.bool:
            if not torch.equal(g, w):
                return float("inf")
            continue
        g, w = g.double(), w.double()
        worst = max(worst, float(((g - w).abs() / (atol + rtol * w.abs())).max()))
    return worst


def replay_profile(collector, want: int) -> dict:
    """One more replay of a collect's captured env step (its step index set
    back to 0, so it writes the first step's slot, or the next ones where
    ``traced`` runs the session again) under torch.profiler."""
    collector.t.zero_()
    return profile_ms(collector.step_graph.graph.replay, 1, "denoise_sweep", want)


def fused_collect_check(dev, label: str, run, sweep: bool, tag: str = "[4 fused]",
                        twin_tol=FUSED_TWIN_TOL) -> dict:
    """Two collects of the run (``train_fused.collect_and_store``: the graph
    of one env step replayed, the transitions into the ring), the counts set
    to 0 just before and read just after; then, on the first collect's
    draws, the eager loop on the card over its first ``FUSED_GRAPH_STEPS``
    steps and the CPU twin over its first ``FUSED_TWIN_STEPS``. Returns the
    launches, the second collect's env steps/s, the capture's seconds and
    the run, which phase 5 profiles."""
    from active_inference_diffusion_torch import train_fused
    from active_inference_diffusion_torch.envs import device_envs as de
    from active_inference_diffusion_torch.ops.denoise import KERNELS, LAUNCHES, PLAIN_RUNS

    n, steps = run.args.num_envs, run.args.steps_per_iter
    kernel = "denoise_sweep_v1_f32"
    eps = train_fused.exploration_eps(run.agent.training_config, 0)
    first_states = de.EnvState(*[x.clone() for x in run.env_states.tensors()])
    first_p = None if run.policy_state is None else run.policy_state.clone()
    snapshot = run.generator.get_state()
    for name in KERNELS:
        LAUNCHES[name] = PLAIN_RUNS[name] = 0
    seconds = []
    for i in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.env_states, run.policy_state, _ = train_fused.collect_and_store(
            run.agent, run.state, run.collector, run.replay, run.env_states, run.policy_state,
            run.generator, eps)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if i == 0:
            first = de.Transitions(*[x.clone() for x in run.collector.out])
    counts = (dict(LAUNCHES), dict(PLAIN_RUNS))
    zero = {name: 0 for name in KERNELS}
    want = ({**zero, kernel: 2 * steps} if sweep else zero, zero)
    if counts != want:
        raise RuntimeError(f"{label}: expected launches {want[0]} and no plain run, got "
                           f"launches {counts[0]}, plain runs {counts[1]}")
    finite = all(bool(torch.isfinite(x.float()).all()) for x in first) and bool(
        torch.isfinite(run.env_states.physics).all())
    if not finite:
        raise RuntimeError(f"{label}: non-finite transitions or physics")

    gen = torch.Generator(device=dev)
    gen.set_state(snapshot)
    compared = min(FUSED_GRAPH_STEPS, steps)
    draws = de.draw_collect(run.env, run.collector.policy, n, compared, gen, reset=False)
    policy = run.collector.policy
    policy.eps.fill_(eps)
    eager, _, _ = de.fused_collect_stateful(
        run.env, policy if policy.stateful else de.stateful(policy), draws, first_p, first_states)
    graph_err = transitions_err(first, eager, compared, *FUSED_GRAPH_TOL)
    twin = twin_of(run.agent)
    cpu_env = de.make_device_env(run.env_name, device="cpu")
    twin_policy = _twin_policy(run, twin, cpu_env)
    cpu_draws = _cpu_collect_draws(draws._replace(steps=draws.steps[:FUSED_TWIN_STEPS]))
    cpu, _, _ = de.fused_collect_stateful(
        cpu_env, twin_policy if twin_policy.stateful else de.stateful(twin_policy), cpu_draws,
        None if first_p is None else first_p.cpu(),
        de.EnvState(*[x.cpu() for x in first_states.tensors()]))
    twin_err = transitions_err(first, cpu, FUSED_TWIN_STEPS, *twin_tol)
    graph = run.collector.step_graph
    log(f"{tag} {label}: {n} envs x {steps} steps, obs width {run.env.observation_dim}, two "
        f"collects of graph replays "
        f"(capture {graph.capture_seconds:.2f} s), launches "
        f"{counts[0][kernel]} of {kernel} ({'one' if sweep else 'none'} per env step), plain "
        f"runs {sum(counts[1].values())}; transitions and physics finite; graph vs the eager "
        f"loop over steps 0-{compared - 1}: err/tol {graph_err:.3e} (rtol "
        f"{FUSED_GRAPH_TOL[0]:g}, atol {FUSED_GRAPH_TOL[1]:g}); card vs CPU twin over steps "
        f"0-{FUSED_TWIN_STEPS - 1}: err/tol {twin_err:.3e} (rtol {twin_tol[0]:g}, atol "
        f"{twin_tol[1]:g}); ring size {run.replay.host_size}")
    if graph_err > 1.0 or twin_err > 1.0:
        raise RuntimeError(f"{label}: the graph collect disagrees with the eager loop or the CPU")
    return dict(launches=counts[0][kernel], steps_per_s=n * steps / seconds[1],
                first_s=seconds[0], capture_s=graph.capture_seconds, run=run,
                first_states=first_states, first_actions=first.actions)


def fused_preset_check(tag: str, preset: str, c: dict) -> dict:
    """``examples/configs/<preset>.yaml`` at its published widths through
    ``train_fused.build_run`` in the loop shape ``c``: ``c["iterations"]``
    calls of ``train_fused.iterate`` (``c["envs"]`` envs x ``c["steps"]``
    steps, ``c["updates"]`` ``train_epoch`` updates) from an empty ring,
    the counts set to 0 just before and read just after, then one
    ``fused_eval`` of ``c["eval_envs"]`` envs cut to ``c["eval_steps"]``
    steps. Metrics finite, the ring's size and position equal to the env
    steps stored, no sweep (the presets act from the posterior). Returns
    the iterations' logs, the eval's seconds, the run and evaluator, and the
    collect's capture seconds."""
    from active_inference_diffusion_torch import train_fused
    from active_inference_diffusion_torch.envs.collect_graph import EvalGraph
    from active_inference_diffusion_torch.envs.device_envs import make_rollout_policy
    from active_inference_diffusion_torch.ops.denoise import KERNELS, LAUNCHES, PLAIN_RUNS

    path = Path(__file__).resolve().parent / "examples" / "configs" / f"{preset}.yaml"
    run = fused_run("--config", str(path), "--num-envs", str(c["envs"]), "--steps-per-iter",
                    str(c["steps"]), "--updates-per-iter", str(c["updates"]), "--iterations",
                    str(c["iterations"]), "--train-epoch")
    cfg = run.agent.config
    for name in KERNELS:
        LAUNCHES[name] = PLAIN_RUNS[name] = 0
    logs = []
    for it in range(c["iterations"]):
        logs.append(train_fused.iterate(run, it))
    evaluator = EvalGraph(run.env, make_rollout_policy(run.agent.core, run.env,
                                                       deterministic=True, act_from_posterior=True),
                          c["eval_envs"], c["eval_steps"])
    te = time.perf_counter()
    ret = float(train_fused.eval_return(run.agent, run.state, evaluator, run.generator))
    eval_s = time.perf_counter() - te
    counts = (sum(LAUNCHES.values()), sum(PLAIN_RUNS.values()))
    stored = c["iterations"] * c["envs"] * c["steps"]
    ring = run.replay
    finite = all(np.isfinite(v) for lg in logs for v in lg.values()) and np.isfinite(ret)
    log(f"{tag} {preset}.yaml B={cfg.batch_size} D={cfg.latent_dim} "
        f"H={cfg.hidden_dim} L={cfg.score_num_layers} K={cfg.diffusion.num_diffusion_steps} "
        f"ensemble {cfg.num_dynamics_ensemble}, sweep weights {cfg.tpu.compute_dtype}, posterior "
        f"acting: {c['iterations']} iterations of "
        f"{c['envs']} envs x {c['steps']} steps and {c['updates']} train_epoch updates (graph "
        f"replays) from an empty ring; ring size {ring.host_size} pos {ring.host_pos} (device "
        f"{int(ring.size)} / {int(ring.pos)}) for {stored} env steps stored; sweeps launched "
        f"{counts[0]}, plain {counts[1]}; collect graph capture "
        f"{run.collector.step_graph.capture_seconds:.2f} s; fused_eval {c['eval_envs']} envs "
        f"cut to {c['eval_steps']} of "
        f"{run.env.max_episode_steps} steps (the script's time): mean return {ret:.4f} in {eval_s:.2f} s "
        f"(capture {evaluator.step_graph.capture_seconds:.2f} s); last metrics "
        + json.dumps({k: round(v, 6) for k, v in logs[-1].items()}))
    if not finite or (ring.host_size, ring.host_pos, int(ring.size), int(ring.pos)) != (
            stored, stored, stored, stored) or counts != (0, 0):
        raise RuntimeError(f"{preset}: non-finite metrics, a ring that does not hold the env "
                           "steps stored, or a sweep")
    return dict(logs=logs, eval_s=eval_s, run=run, evaluator=evaluator,
                capture_s=run.collector.step_graph.capture_seconds)


def fused_phase(dev, launches: dict) -> dict:
    """Phase 4h: the fused collect+train loop on the card (see ``main``).
    Adds the sweep launches of its main paths to ``launches``; returns what
    phase 5 reports."""
    from active_inference_diffusion_torch import train_fused
    from active_inference_diffusion_torch.ops.denoise import KERNELS, LAUNCHES, PLAIN_RUNS

    out = {}
    t0 = time.perf_counter()
    kernel = "denoise_sweep_v1_f32"
    envs, steps = FUSED_PENDULUM
    loop = ["--num-envs", str(envs), "--steps-per-iter", str(steps)]
    # a. Pendulum-v1 with the sweep acting (the entry point's defaults), then warm starts
    for label, extra in (("Pendulum-v1 sweep, K=10", []),
                         (f"Pendulum-v1 warm start, K={FUSED_WARM_STEPS}",
                          ["--warm-start-steps", str(FUSED_WARM_STEPS)])):
        run = fused_run(*loop, *extra, "--eval-every", "1", "--eval-envs", str(FUSED_EVAL_ENVS))
        out[label] = fused_collect_check(dev, label, run, sweep=True)
        launches[kernel] += out[label]["launches"]
    # the eval rollout: one deterministic episode per eval env
    for name in KERNELS:
        LAUNCHES[name] = PLAIN_RUNS[name] = 0
    te = time.perf_counter()
    ret = float(train_fused.eval_return(run.agent, run.state, run.evaluator, run.generator))
    eval_s = time.perf_counter() - te
    counts = (dict(LAUNCHES), dict(PLAIN_RUNS))
    eval_steps = run.evaluator.num_steps
    log(f"[4 fused] Pendulum-v1 fused_eval, {FUSED_EVAL_ENVS} envs x {eval_steps} steps "
        f"(graph replays, capture {run.evaluator.step_graph.capture_seconds:.2f} s): mean "
        f"return {ret:.4f} in {eval_s:.3f} s with the capture, launches {counts[0][kernel]} of "
        f"{kernel}, plain runs {sum(counts[1].values())}")
    if counts[0] != {**{n: 0 for n in KERNELS}, kernel: eval_steps} or any(counts[1].values()) \
            or not np.isfinite(ret):
        raise RuntimeError("Pendulum eval: expected one sweep launch per step and a finite return")
    launches[kernel] += eval_steps
    # b. the planar engine with the sweep acting
    for label, (name, (envs, steps)) in (("HopperPlanar-v0", ("HopperPlanar-v0", FUSED_HOPPER)),
                                         ("Walker2dPlanar-v0",
                                          ("Walker2dPlanar-v0", FUSED_WALKER))):
        run = fused_run("--env", name, "--num-envs", str(envs), "--steps-per-iter", str(steps))
        out[label] = fused_collect_check(dev, label, run, sweep=True)
        launches[kernel] += out[label]["launches"]
    # c. halfcheetah_planar_fused.yaml at its published widths, the README's loop shape
    out["halfcheetah_planar_fused"] = fused_preset_check("[4 fused]", "halfcheetah_planar_fused",
                                                         FUSED_CHEETAH)
    log(f"[4 fused] phase 4h in {time.perf_counter() - t0:.1f} s")
    return out


def fused_times_phase(results: dict, collects, presets: dict, card: str) -> None:
    """Phase 5, the fused loop: env steps/s of each collect named in
    ``collects`` (its second collect, graph replays only) with the capture's
    seconds, and each preset's iterations and eval (``profiled_phase``
    profiles them)."""
    for label in collects:
        r = results[label]
        log(f"[5 times] fused collect {label} ({r['run'].args.num_envs} envs): "
            f"{r['steps_per_s']:.1f} env steps/s (a collect of graph replays into the ring); "
            f"first collect with the capture {r['first_s']:.3f} s, capture "
            f"{r['capture_s']:.3f} s | {card}")
    for preset, c in presets.items():
        r = results[preset]
        for it, lg in enumerate(r["logs"]):
            log(f"[5 times] fused iteration {it} {preset}.yaml ({c['envs']} envs x {c['steps']} "
                f"steps, {c['updates']} train_epoch updates): {lg['fused/env_steps_per_sec']:.2f} "
                f"env steps/s, collect alone {lg['fused/collect_env_steps_per_sec']:.2f} env "
                f"steps/s, {lg.get('fused/updates_per_sec', float('nan')):.3f} updates/s"
                f"{' (with the captures)' if it == 0 else ''} | {card}")
        log(f"[5 times] {preset}.yaml: the collect's step captured in {r['capture_s']:.3f} s; "
            f"eval of {c['eval_envs']} envs x {c['eval_steps']} steps {r['eval_s']:.3f} s (capture "
            f"{r['evaluator'].step_graph.capture_seconds:.3f} s) | {card}")


def rigid3d_phase(dev, launches: dict) -> dict:
    """Phase 4, ``[4 rigid3d]``: the 3D engine in the fused loop (see
    ``main``). Adds the sweep launches of its collects to ``launches``;
    returns what phase 5 reports."""
    out = {}
    t0 = time.perf_counter()
    kernel = "denoise_sweep_v1_f32"
    for name, (envs, steps) in RIGID3D_COLLECTS.items():
        run = fused_run("--env", name, "--num-envs", str(envs), "--steps-per-iter", str(steps))
        out[name] = fused_collect_check(dev, name, run, sweep=True, tag="[4 rigid3d]",
                                        twin_tol=RIGID3D_TWIN_TOL[name])
        launches[kernel] += out[name]["launches"]
        if name != "Ant3D-v0":
            out[name]["f64_twin"] = f64_env_twin(dev, name, out[name]["first_states"],
                                                 out[name]["first_actions"][:C5_STEPS])
        width = 27 if name == "Ant3D-v0" else 376
        if run.env.observation_dim != width:
            raise RuntimeError(f"{name}: observation width {run.env.observation_dim}, "
                               f"expected {width}")
    for preset, c in RIGID3D_PRESETS.items():
        out[preset] = fused_preset_check("[4 rigid3d]", preset, c)
    log(f"[4 rigid3d] phase in {time.perf_counter() - t0:.1f} s")
    return out


# -- [4 ground], [4 resume]: grounded-belief training and checkpoints ---------


def tuned_agent(device, **knobs):
    """examples/configs/halfcheetah_state_tuned.yaml loaded from its file by
    the port's ``load_yaml_config``, ``knobs`` set on its config, at
    HalfCheetah-v4's dimensions on ``device``: the Flax initialisers from
    seed 600, then the score network ``randomize``d (seed 601)."""
    from active_inference_diffusion_torch import DiffusionStateAgent, load_yaml_config

    cfg, training, _ = load_yaml_config(str(Path(__file__).resolve().parent / "examples"
                                            / "configs" / f"{TUNED}.yaml"))
    for name, value in knobs.items():
        setattr(cfg, name, value)
    agent = DiffusionStateAgent(FLAGSHIP_OBS, FLAGSHIP_ACT, cfg, training, device=device)
    agent.core.init_params(torch.Generator(device=device).manual_seed(600))
    randomize(agent.core.score_network, seed=601)
    return agent


def decay_check(dev, ring_state) -> None:
    """The tuned preset with ``policy_lr_decay_steps`` set: two trainers
    from one state, the eager loop and one-update ``train_epoch`` graph
    replays, step by step over steps 0-5, across the decay's end: the
    policy's rate of each (the device tensor the update wrote) against the
    host schedule and against each other, the policy's parameters of the two,
    then the train check on the last step."""
    knobs = dict(policy_lr_decay_steps=TUNED_DECAY_STEPS, policy_lr_final_scale=0.1)
    eager, graph = tuned_agent(dev, **knobs), tuned_agent(dev, **knobs)
    eager_state, graph_state = eager.new_train_state(620), graph.new_train_state(620)
    init = eager.config.learning_rate * eager.config.policy_lr_scale

    def schedule(count: int) -> float:  # optax's cosine_decay_schedule, in float64
        frac = min(count, TUNED_DECAY_STEPS) / TUNED_DECAY_STEPS
        return init * (0.9 * 0.5 * (1.0 + math.cos(math.pi * frac)) + 0.1)

    rates, worst_rate, worst_param = [], 0.0, 0.0
    for step in range(TUNED_DECAY_COMPARED):
        eager_state, eager_metrics = eager_updates(eager, eager_state, ring_state, 1)
        graph_state, graph_metrics = graph_updates(graph, graph_state, ring_state, 1)
        got = [float(s.optimizers["policy"].adamw.param_groups[0]["lr"])
               for s in (eager_state, graph_state)]
        want = schedule(step)
        rates.append(got[1])
        worst_rate = max(worst_rate, abs(got[1] - want) / want)
        if got[0] != got[1]:
            raise RuntimeError(f"policy_lr_decay_steps: step {step} rate {got[1]} replayed, "
                               f"{got[0]} eager")
        worst_param = max(worst_param, max(
            float((p.detach() - q.detach()).abs().max()) for p, q in zip(
                eager.core.policy_network.parameters(), graph.core.policy_network.parameters())))
    torch.cuda.synchronize()
    worst = compare_train_steps(graph_state, graph_metrics[-1], eager_state, eager_metrics[-1])
    log(f"[4 ground] {TUNED}.yaml with policy_lr_decay_steps={TUNED_DECAY_STEPS} (this knob "
        f"changed for this check only): steps 0-{TUNED_DECAY_COMPARED - 1}, graph replays vs the "
        f"eager loop step by step; policy rate per step {[f'{r:.6e}' for r in rates]}, the same "
        f"in both, largest |rate - schedule| / schedule {worst_rate:.3e} (float32 against the "
        f"host's float64; limit 1e-6); largest policy parameter difference {worst_param:.3e}; "
        + describe_train_comparison(worst))
    failed = train_step_fails(worst)
    if worst_rate > 1e-6 or rates[-1] != rates[-2] or failed:
        raise RuntimeError(f"policy_lr_decay_steps: the rate does not follow the schedule, or "
                           f"the graph disagrees with the eager loop: {failed}")


def f64_env_twin(dev, name: str, start, actions) -> float:
    """The env steps of ``name`` in float64 on the card against the CPU, from
    the physics of ``start`` (a collect's env states) with ``actions`` (T, N,
    act) of the collect, no autoreset: the largest err/tol over the
    observations, rewards and physics of every step at ``RIGID3D_F64_TOL``.
    Raises above 1."""
    from active_inference_diffusion_torch.envs.device_envs import EnvState, make_device_env

    envs = [make_device_env(name, device=d, dtype=torch.float64) for d in (dev, "cpu")]
    states = [EnvState(*(x.to(env.device) for x in start.tensors())) for env in envs]
    states = [st.replace(**{f: getattr(st, f).double() for f in ("physics", "obs", "reward")})
              for st in states]
    tol, worst = RIGID3D_F64_TOL, 0.0
    for action in actions:
        states = [env.step(st, action.to(device=env.device, dtype=torch.float64))
                  for env, st in zip(envs, states)]
        for field in ("obs", "reward", "physics"):
            got, want = (getattr(st, field).cpu() for st in states)
            worst = max(worst, float(((got - want).abs() / (tol[1] + tol[0] * want.abs())).max()))
    log(f"[4 rigid3d] {name}: the first collect's {start.physics.shape[0]} envs x "
        f"{actions.shape[0]} steps from its start states with its actions in float64, card vs "
        f"CPU: err/tol {worst:.3e} (rtol {tol[0]:g}, atol {tol[1]:g})")
    if worst > 1.0:
        raise RuntimeError(f"{name}: the float64 env steps of card and CPU disagree")
    return worst


def c5_check(dev) -> dict:
    """C5: Humanoid3D-v0 and HumanoidStandup3D-v0 env steps on the card
    against the CPU from the same states and actions (a seeded reset, then
    ``C5_STEPS`` steps of seeded actions in [-1, 1]), in float64 and in
    float32: the largest err/tol over the observations, rewards and physics
    of every step, at ``C5_TOL`` (float64) and at 4h's ``FUSED_TWIN_TOL``
    (float32). The float64 check must hold; the float32 one is reported."""
    from active_inference_diffusion_torch.envs.device_envs import ResetDraws, make_device_env

    out = {}
    for name in ("Humanoid3D-v0", "HumanoidStandup3D-v0"):
        for dtype, tol in ((torch.float64, C5_TOL), (torch.float32, FUSED_TWIN_TOL)):
            envs = [make_device_env(name, device=d, dtype=dtype) for d in (dev, "cpu")]
            gen = torch.Generator(device="cpu").manual_seed(630)
            draws = envs[1].draw_reset(C5_ENVS, gen)
            actions = 2.0 * torch.rand((C5_STEPS, C5_ENVS, envs[0].action_dim), generator=gen,
                                       dtype=dtype) - 1.0
            states = [envs[0].reset(ResetDraws(*(None if x is None else x.to(dev)
                                                 for x in draws))), envs[1].reset(draws)]
            worst = 0.0
            for step in range(C5_STEPS):
                states = [env.step(st, env.scale_action(actions[step].to(env.device)))
                          for env, st in zip(envs, states)]
                for field in ("obs", "reward", "physics"):
                    got, want = (getattr(st, field).cpu().double() for st in states)
                    worst = max(worst, float(((got - want).abs()
                                              / (tol[1] + tol[0] * want.abs())).max()))
            out[(name, str(dtype).split(".")[-1])] = (worst, tol)
    torch.cuda.synchronize()
    log("[4 ground] C5: Humanoid3D-v0 and HumanoidStandup3D-v0, " f"{C5_ENVS} envs x {C5_STEPS} "
        "env steps from a seeded reset with seeded actions, the card against the CPU on the "
        "same states and actions, err/tol over observation, reward and physics: "
        + "; ".join(f"{n} {d} {w:.3e} (rtol {t[0]:g}, atol {t[1]:g})"
                    for (n, d), (w, t) in out.items()))
    failed = [k for k, (w, _) in out.items() if k[1] == "float64" and w > 1.0]
    if failed:
        raise RuntimeError(f"C5: the float64 env steps of card and CPU disagree: {failed}")
    return out


def ground_phase(dev, launches: dict) -> dict:
    """Phase ``[4 ground]`` (see ``main``). Adds the sweep launches of its
    fused collects to ``launches``; returns what phase 5 reports."""
    from active_inference_diffusion_torch import train_fused
    from active_inference_diffusion_torch.ops.denoise import KERNELS, LAUNCHES, PLAIN_RUNS

    t0 = time.perf_counter()
    kernel = "denoise_sweep_v1_f32"
    out = {}
    # a. one update with explicit draws, card against the CPU twin
    agent = tuned_agent(dev)
    twin = twin_of(agent)
    cfg = agent.config
    batch = train_batch(cfg.batch_size, 610, dev)
    state, twin_state = agent.new_train_state(602), twin.new_train_state(602)
    draws = agent.draw_train(state, cfg.batch_size)
    counts = sweep_counts()
    state, metrics = agent.train_step_from_draws(state, batch, draws)
    torch.cuda.synchronize()
    launched, plain = (now - before for now, before in zip(sweep_counts(), counts))
    twin_state, twin_metrics = twin.train_step_from_draws(
        twin_state, {k: v.cpu() for k, v in batch.items()}, draws.to("cpu"))
    worst = compare_train_steps(state, metrics, twin_state, twin_metrics)
    log(f"[4 ground] {TUNED}.yaml B={cfg.batch_size} D={cfg.latent_dim} H={cfg.hidden_dim} "
        f"L={cfg.score_num_layers} K={cfg.diffusion.num_diffusion_steps} ground_beliefs: one "
        f"update (a MINE step) with explicit draws (the sweep's start and its {draws.sweep_noise.shape[0]} "
        f"steps' noise, {tuple(draws.sweep_noise.shape)}) vs CPU twin; the differentiated "
        f"sweep of {2 * cfg.batch_size} rows ran as {plain} plain sweep (PLAIN_RUNS) and "
        f"{launched} kernel launches: " + describe_train_comparison(worst) + "; metrics "
        + json.dumps({k: round(float(v), 6) for k, v in metrics.items()}))
    failed = train_step_fails(worst)
    if failed or (launched, plain) != (0, 1):
        raise RuntimeError(f"{TUNED}: the card's update disagrees with the CPU twin ({failed}), "
                           "or its sweep was not one plain run")

    # b. graph replays against the eager loop over steps 0-9, then the decaying rate
    ring, described = fill_ring(dev, 640)
    log(f"[4 ground] ring: {described}")
    out["pair"] = epoch_check("[4 ground]", f"{TUNED}.yaml", lambda: tuned_agent(dev),
                              ring.state, plain_per_update=1)[:4]
    out["ring"] = ring
    decay_check(dev, ring.state)

    # c. acting: one act call of the trained agent, the v1-f32 kernel
    counts = (dict(LAUNCHES), dict(PLAIN_RUNS))
    obs = np.random.default_rng(641).standard_normal((cfg.batch_size, FLAGSHIP_OBS))
    actions = agent.act(obs.astype(np.float32), torch.Generator(device=dev).manual_seed(642),
                        state=state)
    torch.cuda.synchronize()
    acted = (LAUNCHES[kernel] - counts[0][kernel], sum(PLAIN_RUNS.values()) - sum(counts[1].values()))
    log(f"[4 ground] act with the trained state, B={cfg.batch_size}, collect sweep of "
        f"{agent.training_config.collect_diffusion_steps} steps: {acted[0]} {kernel} launch, "
        f"{acted[1]} plain sweeps; actions finite {bool(np.isfinite(actions).all())}")
    if acted != (1, 0) or not np.isfinite(actions).all():
        raise RuntimeError(f"{TUNED}: act did not launch the kernel once")
    launches[kernel] += 1

    # d. train_fused on the planar HalfCheetah: the collect's sweep at B=64, K=15
    c = TUNED_FUSED
    path = Path(__file__).resolve().parent / "examples" / "configs" / f"{TUNED}.yaml"
    run = fused_run("--config", str(path), "--env", "HalfCheetahPlanar-v0", "--num-envs",
                    str(c["envs"]), "--steps-per-iter", str(c["steps"]), "--updates-per-iter",
                    str(c["updates"]), "--iterations", str(c["iterations"]), "--train-epoch",
                    seed=650)
    label = f"{TUNED}.yaml on HalfCheetahPlanar-v0"
    out["collect"] = fused_collect_check(dev, label, run, sweep=True, tag="[4 ground]")
    launches[kernel] += out["collect"]["launches"]
    for name in KERNELS:
        LAUNCHES[name] = PLAIN_RUNS[name] = 0
    logs = []
    for it in range(c["iterations"]):
        logs.append(train_fused.iterate(run, it))
    torch.cuda.synchronize()
    captures = run.agent._epoch_graphs.captures  # the run's first train_epoch came here
    counts = (dict(LAUNCHES), dict(PLAIN_RUNS))
    updates = c["iterations"] * c["updates"]
    want = ({**{n: 0 for n in KERNELS}, kernel: c["iterations"] * c["steps"]},
            {**{n: 0 for n in KERNELS}, kernel: updates + captures})
    finite = all(np.isfinite(v) for lg in logs for v in lg.values())
    log(f"[4 ground] {label}: {c['iterations']} train_fused iterations of {c['envs']} envs x "
        f"{c['steps']} steps and {c['updates']} train_epoch updates (graph replays); launches "
        f"{counts[0][kernel]} of {kernel} (B={c['envs']}, K={cfg.diffusion.num_diffusion_steps}, "
        f"one an env step), plain sweeps {counts[1][kernel]} ({updates} replays and {captures} "
        f"captures' warm-ups: the grounded update's differentiated sweep); "
        + "; ".join(f"iteration {it}: {lg['fused/env_steps_per_sec']:.2f} env steps/s, collect "
                    f"alone {lg['fused/collect_env_steps_per_sec']:.2f}, "
                    f"{lg.get('fused/updates_per_sec', float('nan')):.3f} updates/s"
                    for it, lg in enumerate(logs))
        + "; last metrics " + json.dumps({k: round(v, 6) for k, v in logs[-1].items()}))
    if counts != want or not finite:
        raise RuntimeError(f"{label}: expected launches {want[0]} and plain runs {want[1]}, got "
                           f"{counts}, or non-finite metrics")
    launches[kernel] += counts[0][kernel]
    out["logs"] = logs
    out["c5"] = c5_check(dev)
    log(f"[4 ground] phase in {time.perf_counter() - t0:.1f} s")
    return out


def tree_difference(a, b) -> float:
    """The largest absolute difference between two checkpoint trees (inf
    where their structure or a non-tensor value differs)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return float("inf")
        return max([tree_difference(a[k], b[k]) for k in a], default=0.0)
    if isinstance(a, list):
        if len(a) != len(b):
            return float("inf")
        return max([tree_difference(x, y) for x, y in zip(a, b)], default=0.0)
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if a.dtype in (torch.bool, torch.uint8, torch.int64, torch.int32):
            return 0.0 if torch.equal(a, b) else float("inf")
        return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
    return 0.0 if a == b else float("inf")


def resume_phase(dev, launches: dict) -> dict:
    """Phase ``[4 resume]`` (see ``main``): the checkpoint round trip of
    ``train_fused`` on the card. Adds its sweep launches to ``launches``."""
    import shutil

    from active_inference_diffusion_torch import train_fused
    from active_inference_diffusion_torch.ops.denoise import KERNELS, LAUNCHES, PLAIN_RUNS
    from active_inference_diffusion_torch.utils.checkpoints import (
        replay_state_dict,
        train_state_dict,
    )

    t0 = time.perf_counter()
    kernel = "denoise_sweep_v1_f32"
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    c = RESUME_LOOP
    path = Path(__file__).resolve().parent / "examples" / "configs" / f"{TUNED}.yaml"
    loop = ["--config", str(path), "--env", "Pendulum-v1", "--num-envs", str(c["envs"]),
            "--steps-per-iter", str(c["steps"]), "--updates-per-iter", str(c["updates"]),
            "--train-epoch", "--eval-every", "1", "--eval-envs", str(c["eval_envs"]),
            "--log-dir", str(root / "logs")]
    for name in KERNELS:
        LAUNCHES[name] = PLAIN_RUNS[name] = 0
    first = fused_run(*loop, "--iterations", "2", "--checkpoint-dir", str(root / "run"),
                      "--save-replay", seed=700)
    train_fused.train(first)
    resumed = train_fused.build_run(train_fused.parse_args(
        ["--device", "cuda", "--seed", "700", *loop, "--iterations", "1", "--resume",
         str(root / "run" / "final")]))
    torch.cuda.synchronize()
    saved = (train_state_dict(first.agent, first.state), replay_state_dict(first.replay))
    restored = (train_state_dict(resumed.agent, resumed.state), replay_state_dict(resumed.replay))
    state_diff, ring_diff = (tree_difference(a, b) for a, b in zip(saved, restored))
    resumed_at = resumed.total_steps
    carried = (resumed_at, resumed.best_eval, resumed.restored_replay) == (
        first.total_steps, first.best_eval, True)
    # the first update after the resume, and the saved run's next update, on the same ring
    for run in (first, resumed):
        run.state, _ = run.agent.train_epoch(run.state, run.replay, 1)
    torch.cuda.synchronize()
    update_diff = tree_difference(train_state_dict(first.agent, first.state),
                                  train_state_dict(resumed.agent, resumed.state))
    train_fused.train(resumed)
    # a resume without the ring refills it with no update
    bare = root / "final_without_ring"
    shutil.copytree(root / "run" / "final", bare)
    (bare / "replay.pt").unlink()
    refill = train_fused.build_run(train_fused.parse_args(
        ["--device", "cuda", "--seed", "700", *loop, "--iterations", "0", "--resume", str(bare),
         "--resume-refill-steps", str(RESUME_REFILL)]))
    step, steps = refill.state.step, refill.total_steps
    train_fused.train(refill)
    torch.cuda.synchronize()
    refilled = (refill.replay.host_size, refill.state.step, refill.total_steps)
    counts = (LAUNCHES[kernel], sum(PLAIN_RUNS.values()))
    sizes = {p.name: sum(f.stat().st_size for f in p.iterdir())
             for p in (root / "run").iterdir() if p.is_dir()}
    log(f"[4 resume] {TUNED}.yaml on Pendulum-v1, train_fused with --checkpoint-dir "
        f"--eval-every 1 --save-replay for 2 iterations ({c['envs']} envs x {c['steps']} steps, "
        f"{c['updates']} train_epoch updates, eval {c['eval_envs']} envs): checkpoints "
        f"{json.dumps(sizes)} bytes, best eval {first.best_eval:.4f}; --resume final: every "
        f"parameter, moment, count, rate, EMA, state field and the generator's state, largest "
        f"difference {state_diff:.3e}; the ring and its mirrors {ring_diff:.3e}; total_steps "
        f"{resumed_at}, best eval and the restored ring carried {carried}; the first "
        f"update after the resume against the saved run's next update on the same ring and "
        f"draws, largest difference {update_diff:.3e} (tolerance 0); then one iteration; a "
        f"resume without the ring refilled {refilled[0]} transitions (target {RESUME_REFILL}) "
        f"at state step {refilled[1]} (before {step}), total_steps {steps} -> {refilled[2]}; "
        f"{counts[0]} {kernel} launches (collects and evals), {counts[1]} plain sweeps")
    if (state_diff, ring_diff, update_diff) != (0.0, 0.0, 0.0) or not carried or refilled[0] < \
            RESUME_REFILL or refilled[1] != step or refilled[2] != steps + refilled[0]:
        raise RuntimeError("[4 resume]: the restored run differs from the saved one, or the "
                           "refill took updates")
    launches[kernel] += counts[0]
    shutil.rmtree(root)
    log(f"[4 resume] phase in {time.perf_counter() - t0:.1f} s")


def profiled_phase(dev, card: str) -> None:
    """Phase 5's replays under torch.profiler, run by ``profiled_main`` in a
    process of its own. In the process of phases 1-5, where the profiler
    ran between the captures of many graphs, a profiled graph replay
    sometimes died of a segfault, cause unknown (PERF.md, section
    7). Here every graph is captured before the first profiler session,
    none is captured during one, and all stay alive to the end.

    The flagship's ``train_epoch``, v1: ten replays, one sweep kernel and
    one graph launch each in the trace, device time, busy share, launches
    outside the graph. ``train_step`` at the flagship, v1 and v2, eager: 5
    steps each (device time, the sweep's share, host time per phase). The
    HalfCheetah learning preset's ``train_epoch``: ten replays (no sweep
    kernel in the trace) and three eager updates. The fused loop: one
    replayed env step of each collect of 4h (its kernels, the graph's
    nodes; one sweep kernel in it where the policy acts by the sweep, none
    in the HalfCheetah preset's), one collect of each Pendulum run (one
    sweep kernel an env step, the sweep's share of the device time, the
    busy share)."""
    from active_inference_diffusion_torch import train_fused

    t0 = time.perf_counter()
    # -- every graph captured first
    ring, _ = fill_ring(dev)
    flagship = flagship_agent(dev, train=True)
    flagship_state, _ = graph_updates(flagship, flagship.new_train_state(305), ring.state,
                                      EPOCH_COMPARED)
    trainer = flagship_agent(dev, train=True)
    batch = train_batch(FLAGSHIP["batch"], 310, dev)
    obs_dim, act_dim = DREAMER_SHAPES["halfcheetah"]
    dreamer_ring, _ = fill_ring(dev, 420, obs_dim, act_dim)
    dreamer_eager, dreamer = dreamer_agent("halfcheetah", dev), dreamer_agent("halfcheetah", dev)
    dreamer_eager_state = dreamer_eager.new_train_state(405)
    dreamer_state, _ = graph_updates(dreamer, dreamer.new_train_state(405), dreamer_ring.state,
                                     EPOCH_COMPARED)
    grounded = tuned_agent(dev)
    grounded_state, _ = graph_updates(grounded, grounded.new_train_state(405), ring.state,
                                      EPOCH_COMPARED)
    envs, steps = FUSED_PENDULUM
    loop = ["--num-envs", str(envs), "--steps-per-iter", str(steps)]
    c = FUSED_CHEETAH
    path = Path(__file__).resolve().parent / "examples" / "configs" / "halfcheetah_planar_fused.yaml"
    pendulum = ("Pendulum-v1 sweep, K=10", f"Pendulum-v1 warm start, K={FUSED_WARM_STEPS}")
    runs = {
        pendulum[0]: fused_run(*loop),
        pendulum[1]: fused_run(*loop, "--warm-start-steps", str(FUSED_WARM_STEPS)),
        "HopperPlanar-v0": fused_run("--env", "HopperPlanar-v0", "--num-envs",
                                     str(FUSED_HOPPER[0]), "--steps-per-iter", str(FUSED_HOPPER[1])),
        "Walker2dPlanar-v0": fused_run("--env", "Walker2dPlanar-v0", "--num-envs",
                                       str(FUSED_WALKER[0]), "--steps-per-iter",
                                       str(FUSED_WALKER[1])),
        "HalfCheetahPlanar-v0": fused_run("--config", str(path), "--num-envs", str(c["envs"]),
                                          "--steps-per-iter", str(c["steps"])),
    }
    for name, (n, t) in RIGID3D_COLLECTS.items():
        runs[name] = fused_run("--env", name, "--num-envs", str(n), "--steps-per-iter", str(t))
    tuned = Path(__file__).resolve().parent / "examples" / "configs" / f"{TUNED}.yaml"
    runs[f"{TUNED}.yaml on HalfCheetahPlanar-v0"] = fused_run(
        "--config", str(tuned), "--env", "HalfCheetahPlanar-v0", "--num-envs",
        str(TUNED_FUSED["envs"]), "--steps-per-iter", str(TUNED_FUSED["steps"]), seed=650)

    def collect(run):
        run.env_states, run.policy_state, _ = train_fused.collect_and_store(
            run.agent, run.state, run.collector, run.replay, run.env_states, run.policy_state,
            run.generator, 0.1)

    for run in runs.values():
        collect(run)  # the first collect captures the env step
    for _ in range(TRAIN_WARMUP):
        trainer.train_step(trainer.new_train_state(304), batch)
    torch.cuda.synchronize()
    epoch_graphs = [flagship._epoch_graphs, dreamer._epoch_graphs, grounded._epoch_graphs]
    captures = [g.captures for g in epoch_graphs]
    log(f"[5 profiled] set-up: the flagship's, the HalfCheetah learning preset's and the tuned "
        f"preset's epoch graphs ({captures[0]}, {captures[1]} and {captures[2]} captured), the "
        f"{len(runs)} collects' env steps "
        f"captured, in {time.perf_counter() - t0:.1f} s")

    # -- the profiled replays
    flagship_state, prof = profile_epoch(flagship, flagship_state, ring.state, EPOCH_PROFILED,
                                         EPOCH_PROFILED)
    log(f"[5 profiled] train_epoch flagship v1-f32 B={FLAGSHIP['batch']}, {EPOCH_PROFILED} "
        f"replays: {prof['sweep_kernels']} sweep kernels and {prof['graph_launches']} graph "
        f"launches in the trace, launches counted {prof['launches']}; host {prof['host_ms']:.4f} "
        f"ms, device {prof['device_ms']:.4f} ms an update, device busy "
        f"{prof['device_ms'] / prof['host_ms']:.3%}, {prof['launches_outside']:.1f} launches an "
        f"update outside the graph (kernels, copies, fills), sweep kernel {prof['sweep_ms']:.4f} "
        f"ms an update | {card}")
    if (prof["sweep_kernels"] != EPOCH_PROFILED or prof["graph_launches"] != EPOCH_PROFILED
            or prof["launches"] != EPOCH_PROFILED or not prof["metrics_finite"]):
        raise RuntimeError("epoch: the profiler does not see one sweep kernel and one graph "
                           "launch per replayed update")

    for variant in ("v1", "v2"):
        trainer.config.tpu.denoiser_kernel = variant
        timed_state = trainer.new_train_state(304)

        def train_call():
            nonlocal timed_state
            timed_state, _ = trainer.train_step(timed_state, batch)

        train_call()
        prof = profile_ms(train_call, 5, "denoise_sweep", 5)
        log(f"[5 profiled] train_step flagship {variant}-f32 B={FLAGSHIP['batch']}, 5 steps: host "
            f"{prof['host_ms']:.4f} ms, device {prof['device_ms']:.4f} ms a step in "
            f"{prof['kernels_per_call']:.0f} kernels, sweep kernel {prof['named_ms']:.4f} ms "
            f"({prof['named_ms'] / prof['host_ms']:.3%} of the step, "
            f"{prof['named_ms'] / prof['device_ms']:.3%} of device time), device busy "
            f"{prof['device_ms'] / prof['host_ms']:.3%}; host ms a step by phase "
            + json.dumps({k: round(v, 3) for k, v in prof["phases_host_ms"].items()})
            + f" | {card}")
        if prof["named_kernels"] != 5:
            raise RuntimeError(f"train_step {variant}: {prof['named_kernels']} sweep kernels in "
                               "the trace of 5 steps")

    dreamer_state, prof = profile_epoch(dreamer, dreamer_state, dreamer_ring.state,
                                        EPOCH_PROFILED, 0)

    def eager_call():
        nonlocal dreamer_eager_state
        dreamer_eager_state, _ = eager_updates(dreamer_eager, dreamer_eager_state,
                                               dreamer_ring.state, 1)

    eager_call()
    eager_prof = profile_ms(eager_call, 3, "denoise_sweep", 0)
    log(f"[5 profiled] train_epoch halfcheetah_state_dreamer B={dreamer.config.batch_size}, "
        f"{EPOCH_PROFILED} replays: host {prof['host_ms']:.4f} ms, device "
        f"{prof['device_ms']:.4f} ms an update in {prof['device_ops']:.0f} kernels and copies, "
        f"device busy {prof['device_ms'] / prof['host_ms']:.3%}, "
        f"{prof['launches_outside']:.1f} launches an update outside the graph, "
        f"{prof['sweep_kernels']} sweep kernels; eager, 3 updates: host "
        f"{eager_prof['host_ms']:.4f} ms, device {eager_prof['device_ms']:.4f} ms an update in "
        f"{eager_prof['kernels_per_call']:.0f} kernels, busy "
        f"{eager_prof['device_ms'] / eager_prof['host_ms']:.3%}; host ms an update by phase "
        + json.dumps({k: round(v, 3) for k, v in eager_prof["phases_host_ms"].items()})
        + f" | {card}")
    if prof["sweep_kernels"] or eager_prof["named_kernels"] or not prof["metrics_finite"]:
        raise RuntimeError("dreamer epoch: a sweep in the trace, or non-finite metrics")

    grounded_state, prof = profile_epoch(grounded, grounded_state, ring.state, GROUND_PROFILED,
                                                 0)
    log(f"[5 profiled] train_epoch {TUNED} B={grounded.config.batch_size} (ground_beliefs), "
        f"{GROUND_PROFILED} replays: host {prof['host_ms']:.4f} ms, device "
        f"{prof['device_ms']:.4f} ms an update in {prof['device_ops']:.0f} kernels and copies, "
        f"device busy {prof['device_ms'] / prof['host_ms']:.3%}, "
        f"{prof['launches_outside']:.1f} launches an update outside the graph, "
        f"{prof['sweep_kernels']} sweep kernels (the differentiated sweep is plain) | {card}")
    if prof["sweep_kernels"] or not prof["metrics_finite"]:
        raise RuntimeError("grounded epoch: a sweep kernel in the trace, or non-finite metrics")

    for label, run in runs.items():
        want = 0 if label == "HalfCheetahPlanar-v0" else 1
        step = replay_profile(run.collector, want)
        log(f"[5 profiled] fused collect {label} ({run.args.num_envs} envs): one replayed env "
            f"step, {step['kernels_per_call']:.0f} kernels and copies (the graph's nodes), "
            f"{step['named_kernels']} sweep kernel {step['named_ms']:.4f} ms "
            f"({step['named_ms'] / step['device_ms']:.3%} of the step's device time), device "
            f"{step['device_ms']:.4f} ms, host {step['host_ms']:.4f} ms, device busy "
            f"{step['device_ms'] / step['host_ms']:.3%} | {card}")
        if step["named_kernels"] != want:
            raise RuntimeError(f"{label}: {step['named_kernels']} sweep kernels in the trace of "
                               f"one replayed env step, expected {want}")
    for label in pendulum + ("Ant3D-v0",):
        run = runs[label]
        envs, steps = run.args.num_envs, run.args.steps_per_iter
        prof = profile_ms(lambda: collect(run), 1, "denoise_sweep", steps)
        log(f"[5 profiled] fused collect {label} (one collect of {steps} steps x {envs} envs, "
            f"graph replays): host {prof['host_ms']:.4f} ms, device {prof['device_ms']:.4f} ms "
            f"in {prof['kernels_per_call'] / steps:.0f} kernels a step, {prof['named_kernels']} "
            f"sweep kernels {prof['named_ms']:.4f} ms ({prof['named_ms'] / prof['device_ms']:.3%} "
            f"of device time), device busy {prof['device_ms'] / prof['host_ms']:.3%} | {card}")
        if prof["named_kernels"] != steps:
            raise RuntimeError(f"{label}: {prof['named_kernels']} sweep kernels in the trace of a "
                               f"collect of {steps} replayed steps, expected {steps}")
    if [g.captures for g in epoch_graphs] != captures:
        raise RuntimeError("an epoch graph was captured while the profiler ran")
    log(f"[5 profiled] phase in {time.perf_counter() - t0:.1f} s")


def profiled_main() -> int:
    """``python3 chip_smoke.py --profiled``, the process that ``main``
    starts for ``profiled_phase``: the card, the kernels ``main`` built
    (the build is cached), then the profiled replays."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    from active_inference_diffusion_torch.ops import _build

    for name in _build.build():
        _build.load_library(name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    profiled_phase(torch.device("cuda"), nvidia_smi())
    return 0


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
    from active_inference_diffusion_torch.configs.presets import (
        HUMANOID_ACT_DIM,
        HUMANOID_OBS_DIM,
        humanoid_state,
    )
    from active_inference_diffusion_torch.ops import _build
    from active_inference_diffusion_torch.ops.denoise import (
        KERNELS,
        LAUNCHES,
        PLAIN_RUNS,
        denoise_sweep_reference,
        kernel_name,
        kernel_smem_bytes,
        max_active_clusters,
    )

    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    libraries = _build.build()
    for name in libraries:
        _build.load_library(name)
    log(f"[2 build] {', '.join(str(p) for p in libraries.values())} in "
        f"{time.perf_counter() - t0:.2f} s")
    for name in libraries:
        for line in _build.build_log(name).read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[2 build] ptxas {name}: {line.strip()}")
    for kernel, (variant, dtype, library, _) in KERNELS.items():
        for latent, hidden, streamed in ((64, 256, False), (32, 128, False), (128, 512, True)):
            smem = kernel_smem_bytes(latent, hidden, variant, dtype, streamed)
            count = max_active_clusters(_build.load_library(library), variant, dtype, smem,
                                        streamed)
            log(f"[2 build] {kernel} D={latent} H={hidden} "
                f"{'streamed' if streamed else 'resident'}: {smem} B of shared memory a CTA, "
                f"{count} clusters at once")

    # -- 3. kernels vs plain version ----------------------------------------
    max_abs_err = {name: 0.0 for name in KERNELS}
    for row in parity_rows():
        kernel, name = row["kernel"], row["row"]
        max_abs_err[kernel] = max(max_abs_err[kernel], row["max_abs_err"])
        rtol, atol = SWEEP_TOL[KERNELS[kernel][1]]
        log(f"[3 parity] {kernel} {name} B={row['batch']} D={row['latent']} H={row['hidden']} "
            f"L={row['layers']} K={row['steps']}/{row['schedule']} "
            f"{'det' if row['deterministic'] else 'sto'}: max|err| {row['max_abs_err']:.3e} "
            f"max|plain| {row['max_abs_plain']:.3e} err/tol {row['err_over_tol']:.3f} "
            f"(tol {atol:g} + {rtol:g}|plain|)")
        if row["err_over_tol"] > 1.0:
            raise RuntimeError(f"{kernel} {name}: kernel disagrees with its plain version")

    # -- 4. main paths ------------------------------------------------------
    def check_actions(actions, batch, act_dim):
        if actions.shape != (batch, act_dim) or not np.isfinite(actions).all():
            raise RuntimeError(f"act returned {actions.shape}, finite={np.isfinite(actions).all()}")
        if np.abs(actions).max() > 1.0:
            raise RuntimeError("act returned actions outside [-1, 1]")

    def main_path(label, agent, twin, kernel, batch, calls, warm_calls=0, seed=0):
        """``calls`` eval + ``calls`` collect ``act`` calls, then
        ``warm_calls`` eval ``act_warm`` calls; counts, checks, and the eval
        actions held against the CPU twin. Returns the launches."""
        obs_dim, act_dim = agent.observation_dim, agent.action_dim
        atol = ACT_ATOL[agent.core.sweep_dtype]
        rng = np.random.default_rng(seed)
        gen = torch.Generator(device=dev).manual_seed(seed)
        evals, warms = [], []
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for _ in range(calls):
            obs = rng.standard_normal((batch, obs_dim)).astype(np.float32)
            state = gen.get_state()
            evals.append((obs, state, agent.act(obs, gen, deterministic=True, collect=False)))
            collect = agent.act(obs, gen, deterministic=False, collect=True)
            for actions in (evals[-1][2], collect):
                check_actions(actions, batch, act_dim)
        prev = torch.zeros((batch, agent.core.latent_dim), device=dev)
        for i in range(warm_calls):
            obs = rng.standard_normal((batch, obs_dim)).astype(np.float32)
            reset = np.ones(batch, bool) if i == 0 else rng.random(batch) < 0.25
            state = gen.get_state()
            actions, latents = agent.act_warm(obs, gen, prev, reset, deterministic=True)
            check_actions(actions, batch, act_dim)
            warms.append((obs, reset, prev, state, actions, latents))
            prev = latents
        launches = dict(LAUNCHES)
        total = 2 * calls + warm_calls
        log(f"[4 main path] {label} B={batch}: {2 * calls} act + {warm_calls} act_warm calls, "
            f"launches {launches}")
        if launches != {**{name: 0 for name in KERNELS}, kernel: total}:
            raise RuntimeError(f"{label}: expected {total} launches of {kernel} and no other")

        err = 0.0
        replay = torch.Generator(device=dev)
        for obs, state, actions in evals:
            replay.set_state(state)
            start = agent.core.draw_start(batch, replay)
            plain, _ = twin.act_from_start(
                torch.from_numpy(obs), start.to("cpu"), None, deterministic=True
            )
            err = max(err, float(np.abs(plain.numpy() - actions).max()))
        warm_err = 0.0
        for obs, reset, prev, state, actions, latents in warms:
            replay.set_state(state)
            fresh = torch.randn(prev.shape, generator=replay, device=dev)
            start = agent.core.draw_start(batch, replay)
            plain, _ = twin.act_warm_from_start(
                torch.from_numpy(obs), prev.cpu(), torch.from_numpy(reset), fresh.cpu(),
                start.to("cpu"), None, deterministic=True,
                num_steps=twin.training_config.collect_diffusion_steps,
            )
            warm_err = max(warm_err, float(np.abs(plain.numpy() - actions).max()))
        log(f"[4 main path] {label} B={batch}: eval actions vs plain path (CPU): max|err| "
            f"act {err:.3e}, act_warm {warm_err:.3e} (tol {atol:g})")
        if max(err, warm_err) > atol:
            raise RuntimeError(f"{label}: the card's actions disagree with the plain path")
        return launches[kernel]

    launches = {}
    flagship = flagship_agent(dev)
    flagship_cfg = flagship.config
    twin = twin_of(flagship)
    launches["denoise_sweep_v1_f32"] = main_path(
        "flagship v1-f32", flagship, twin, "denoise_sweep_v1_f32", FLAGSHIP["batch"], 20
    )
    flagship_cfg.tpu.denoiser_kernel = "v2"
    launches["denoise_sweep_v2_f32"] = main_path(
        "flagship v2-f32", flagship, twin, "denoise_sweep_v2_f32", FLAGSHIP["batch"], 5, seed=1
    )
    flagship_cfg.tpu.denoiser_kernel = "v1"

    humanoid_cfg, humanoid_training = humanoid_state()
    humanoid = DiffusionStateAgent(
        HUMANOID_OBS_DIM, HUMANOID_ACT_DIM, humanoid_cfg, humanoid_training
    )
    randomize(humanoid.core, seed=200)
    htwin = twin_of(humanoid)
    for variant in ("v1", "v2"):
        humanoid_cfg.tpu.denoiser_kernel = variant
        kernel = f"denoise_sweep_{variant}_bf16"
        launches[kernel] = sum(
            main_path(f"humanoid {variant}-bf16", humanoid, htwin, kernel, batch, 20,
                      warm_calls=4, seed=batch)
            for batch in HUMANOID_BATCHES
        )
    humanoid_cfg.tpu.denoiser_kernel = "v1"

    # C1: beyond the kernels' 48 MiB of trunk weights the card runs the plain
    # sweep; within it, at the widths C1 found refused, the kernel runs.
    for (latent, hidden, dtype), path in C1_WIDTHS.items():
        cfg = ActiveInferenceConfig(observation_dim=FLAGSHIP_OBS, action_dim=FLAGSHIP_ACT,
                                    latent_dim=latent, hidden_dim=hidden,
                                    diffusion=DiffusionConfig(num_diffusion_steps=C1_STEPS))
        cfg.tpu.compute_dtype = dtype
        agent = DiffusionStateAgent(FLAGSHIP_OBS, FLAGSHIP_ACT, cfg, TrainingConfig())
        label = f"latent {latent} hidden {hidden} {dtype}"
        if agent.core.sweep_uses_kernel != (path == "kernel"):
            raise RuntimeError(f"{label}: sweep_uses_kernel is {agent.core.sweep_uses_kernel}, "
                               f"expected the {path} path")
        randomize(agent.core, seed=hidden)
        twin = twin_of(agent)
        obs = np.random.default_rng(hidden).standard_normal((8, FLAGSHIP_OBS)).astype(np.float32)
        gen = torch.Generator(device=dev).manual_seed(hidden)
        state = gen.get_state()
        for name in KERNELS:
            LAUNCHES[name] = PLAIN_RUNS[name] = 0
        actions = agent.act(obs, gen, deterministic=True, collect=False)
        belief = agent.core.generate_beliefs(gen, torch.from_numpy(obs).to(dev))
        torch.cuda.synchronize()
        name = kernel_name("v1", agent.core.sweep_dtype)
        counts = (dict(LAUNCHES), dict(PLAIN_RUNS))
        zero = {n: 0 for n in KERNELS}
        want_counts = (zero, {**zero, name: 2}) if path == "plain" else ({**zero, name: 2}, zero)
        if counts != want_counts:
            raise RuntimeError(f"{label}: expected 2 {path} runs of {name} and no other, got "
                               f"launches {counts[0]}, plain runs {counts[1]}")
        if path == "kernel":
            launches[name] += 2
        check_actions(actions, 8, FLAGSHIP_ACT)
        gen.set_state(state)
        start = agent.core.draw_start(8, gen)
        plain, _ = twin.act_from_start(torch.from_numpy(obs), start.to("cpu"), None,
                                       deterministic=True)
        start = agent.core.draw_start(8, gen)
        want = twin.core.beliefs_from_start(torch.from_numpy(obs), start.noise.cpu(),
                                            start.seed.cpu())
        atol = ACT_ATOL[agent.core.sweep_dtype]
        rtol_b, atol_b = SWEEP_TOL[agent.core.sweep_dtype]
        act_err = float(np.abs(plain.numpy() - actions).max())
        lat_ratio = float(((belief.latent.cpu() - want.latent)
                           .abs() / (atol_b + rtol_b * want.latent.abs())).max())
        rec = (float(belief.reconstruction_error), float(want.reconstruction_error))
        log(f"[4 c1] {label} B=8 K={C1_STEPS}: {path}, launches {counts[0][name]}, plain runs "
            f"{counts[1][name]}; eval actions vs CPU max|err| {act_err:.3e} (tol {atol:g}); "
            f"belief latents err/tol {lat_ratio:.3f}; reconstruction error {rec[0]:.6g} vs "
            f"{rec[1]:.6g}")
        if act_err > atol or lat_ratio > 1.0 or abs(rec[0] - rec[1]) > atol_b + rtol_b * abs(rec[1]):
            raise RuntimeError(f"{label}: the card's {path} path disagrees with the CPU")

    # 4e. The flagship train update: one belief sweep of 2 x 256 rows a step.
    trainer = flagship_agent(dev, train=True)
    train_cfg = trainer.config
    train_state = trainer.new_train_state(302)
    train_twin = twin_of(trainer)
    train_batches = [train_batch(FLAGSHIP["batch"], 310 + i, dev) for i in range(2)]
    train_launches = {}
    for variant in ("v1", "v2"):
        train_cfg.tpu.denoiser_kernel = variant
        kernel = kernel_name(variant, torch.float32)
        steps = TRAIN_STEPS[variant]
        before = [p.detach().clone() for p in trainer.core.parameters()]
        first_step = train_state.step
        for name in KERNELS:
            LAUNCHES[name] = PLAIN_RUNS[name] = 0
        for i in range(steps):
            mine = train_state.step % train_cfg.epistemic_update_every == 0
            train_state, metrics = trainer.train_step(train_state, train_batches[i % 2])
            bad = [k for k, v in metrics.items() if not torch.isfinite(v)]
            if bad or (float(metrics["epistemic_mi"]) != 0.0) != mine:
                raise RuntimeError(f"train {variant} step {train_state.step - 1}: non-finite {bad} "
                                   f"or the MINE update ran where it should not (mine={mine})")
        torch.cuda.synchronize()
        counts = (dict(LAUNCHES), dict(PLAIN_RUNS))
        log(f"[4 train] flagship {variant}-f32 B={FLAGSHIP['batch']}: {steps} train_step calls "
            f"from step {first_step}, launches {counts[0]}, plain runs {sum(counts[1].values())}")
        if counts != ({**{n: 0 for n in KERNELS}, kernel: steps}, {n: 0 for n in KERNELS}):
            raise RuntimeError(f"train {variant}: expected {steps} launches of {kernel} and no other")
        params = list(trainer.core.parameters())
        for part, opt in train_state.optimizers.items():
            ids = {id(p) for p in opt.params}
            if all(torch.equal(p, b) for p, b in zip(params, before) if id(p) in ids):
                raise RuntimeError(f"train {variant}: the {part} partition did not move")
        log(f"[4 train] flagship {variant}: losses finite at every step, MINE at steps "
            f"{[s for s in range(first_step, first_step + steps) if s % 5 == 0]}, every partition "
            f"moved; last metrics " + json.dumps({k: round(float(v), 6) for k, v in metrics.items()}))
        train_launches[kernel] = steps

        # one deterministic update from fresh states, the draws shared with the CPU twin
        train_cfg.deterministic_beliefs = True
        train_twin.core.load_state_dict(trainer.core.state_dict())
        card_state, twin_state = trainer.new_train_state(303), train_twin.new_train_state(303)
        draws = trainer.draw_train(card_state, FLAGSHIP["batch"])
        for name in KERNELS:
            LAUNCHES[name] = 0
        card_state, card_metrics = trainer.train_step_from_draws(card_state, train_batches[0],
                                                                  draws)
        torch.cuda.synchronize()
        if LAUNCHES[kernel] != 1 or sum(LAUNCHES.values()) != 1:
            raise RuntimeError(f"train {variant}: the deterministic step launched {LAUNCHES}")
        train_launches[kernel] += 1
        twin_state, twin_metrics = train_twin.train_step_from_draws(
            twin_state, {k: v.cpu() for k, v in train_batches[0].items()}, draws.to("cpu")
        )
        worst = compare_train_steps(card_state, card_metrics, twin_state, twin_metrics)
        log(f"[4 train] flagship {variant} deterministic step vs CPU twin: "
            + describe_train_comparison(worst))
        failed = train_step_fails(worst)
        if failed:
            raise RuntimeError(f"train {variant}: the card's update disagrees with the CPU twin: "
                               f"{failed}")
        if variant == "v1":
            # control: the same step with TF32 products on the card must fail the gradients' limits
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control_state, control_metrics = trainer.train_step_from_draws(
                    trainer.new_train_state(303), train_batches[0], draws)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            control = compare_train_steps(control_state, control_metrics, twin_state, twin_metrics)
            log("[4 train] control, the same step with TF32 products on the card, vs CPU twin: "
                + describe_train_comparison(control))
            if "epistemic moments" not in train_step_fails(control):
                raise RuntimeError("the MINE gradient's limit passes a step with TF32 products")
            train_launches[kernel] += 1
        train_cfg.deterministic_beliefs = False
    train_cfg.tpu.denoiser_kernel = "v1"
    for kernel, count in train_launches.items():
        launches[kernel] += count

    # 4f. The replay ring and train_epoch: each update a replayed CUDA graph.
    ring, epoch_pairs = epoch_phase(dev, launches)

    # 4g. The learning presets: posterior beliefs, the imagined actor-critic.
    t0 = time.perf_counter()
    dreamer = dreamer_phase(dev, launches)
    log(f"[4 dreamer] phase 4g in {time.perf_counter() - t0:.1f} s")



    # -- 5. times -----------------------------------------------------------
    hum = dict(batch=256, latent=64, hidden=256, layers=6, schedule_len=50, steps=50)
    flag = dict(batch=256, latent=32, hidden=128, layers=6, schedule_len=25, steps=25)
    collect_shape = dict(batch=1024, latent=16, hidden=64, layers=2, schedule_len=10, steps=10)
    timed = [  # (kernel, shape label, shape); the first row of a kernel goes in its line
        ("denoise_sweep_v1_f32", "flagship", flag),
        ("denoise_sweep_v1_bf16", "humanoid_state", hum),
        ("denoise_sweep_v2_f32", "humanoid_state", hum),
        ("denoise_sweep_v2_bf16", "humanoid_state", hum),
        ("denoise_sweep_v1_f32", "humanoid_state", hum),
        ("denoise_sweep_v1_bf16", "humanoid_state_b8", dict(hum, batch=8)),
        ("denoise_sweep_v2_bf16", "humanoid_state_b8", dict(hum, batch=8)),
        ("denoise_sweep_v1_f32", "flagship_b1", dict(flag, batch=1)),
        ("denoise_sweep_v2_f32", "flagship", flag),
        ("denoise_sweep_v2_f32", "humanoid_state_b8", dict(hum, batch=8)),
        ("denoise_sweep_v1_f32", "flagship_b512", dict(flag, batch=512)),
        # the C1 widths the kernels take: the default in bfloat16 (streamed), hidden 96
        ("denoise_sweep_v1_bf16", "default", dict(batch=8, latent=128, hidden=512, layers=6,
                                                   schedule_len=100, steps=100)),
        ("denoise_sweep_v1_f32", "h96", dict(batch=8, latent=128, hidden=96, layers=6,
                                              schedule_len=100, steps=100)),
        # C4's sweep at the learning preset's width, and the fused collect's sweeps
        ("denoise_sweep_v1_f32", "dreamer_c4", dict(flag, batch=16, schedule_len=15, steps=15)),
        ("denoise_sweep_v1_f32", "fused_pendulum", collect_shape),
        ("denoise_sweep_v1_f32", "fused_pendulum_warm", dict(collect_shape, steps=3)),
        ("denoise_sweep_v1_f32", "fused_hopper", dict(collect_shape, batch=512)),
        ("denoise_sweep_v1_f32", "fused_eval", dict(collect_shape, batch=64)),
        ("denoise_sweep_v1_f32", "fused_ant3d", dict(collect_shape, batch=256)),
        # the tuned preset's collect on HalfCheetahPlanar-v0 ([4 ground])
        ("denoise_sweep_v1_f32", "tuned_collect", dict(flag, batch=64, schedule_len=15,
                                                        steps=15)),
    ]
    summary = {}
    for kernel, label, shape in timed:
        wrapper, args = sweep_inputs(kernel, **shape, seed=7)
        arms = {
            "kernel": lambda: wrapper(*args, deterministic=False),
            "plain": lambda: denoise_sweep_reference(*args, deterministic=False),
        }
        calls = TIMED_CALLS if label.startswith("flagship") else 10
        samples = {name: [] for name in arms}
        for name in arms:
            cuda_ms(arms[name], WARMUP_CALLS)
        for name in ("plain", "kernel", "kernel", "plain"):
            samples[name] += cuda_ms(arms[name], (calls + 1) // 2)
        ms = {name: statistics.median(v) for name, v in samples.items()}
        # the yardstick: the plain version as one CUDA graph
        ms["library"] = graph_ms(lambda: denoise_sweep_reference(*args, deterministic=False),
                                 calls)
        packed, z0, obs_emb, t_embs = args[1], args[2], args[3], args[4]
        graphs = f"plain as a CUDA graph {ms['library']:.4f} ms"
        if packed.dtype == torch.bfloat16:
            rtol, atol = SWEEP_TOL[torch.bfloat16]
            want = denoise_sweep_reference(*args, deterministic=False)
            worst = float(((plain_bf16_products(args) - want).abs()
                           / (atol + rtol * want.abs())).max())
            if worst > 1.0:
                raise RuntimeError(f"{kernel} {label}: the bf16 yardstick computes another sweep")
            ms["library_bf16"] = graph_ms(lambda: plain_bf16_products(args), calls)
            graphs += (f", with bf16 x bf16 products {ms['library_bf16']:.4f} ms "
                       f"(err/tol {worst:.3f} against plain)")
        b, k = z0.shape[0], args[6]
        weights = sum(
            int(np.prod(shape)) for name, (_, shape) in packed.offsets.items() if name.endswith("_w")
        )
        flops = 2.0 * weights * b * k
        nbytes = (packed.weights.numel() * packed.weights.element_size()
                  + 4 * (packed.biases.numel() + z0.numel() + obs_emb.numel() + t_embs.numel()
                         + 8 * k + z0.numel()))
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3,
                 "operations": flops / PEAK_FLOPS[packed.dtype] * 1e3}
        bound_by = max(bound, key=bound.get)
        log(f"[5 times] {kernel} {label} B={b} K={k}: kernel median {ms['kernel']:.4f} ms, "
            f"plain {ms['plain']:.4f} ms over {len(samples['kernel'])} calls each (stochastic), "
            f"{graphs}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB, bound "
            f"{bound[bound_by]:.4f} ms ({bound_by}) | {card}")
        if kernel not in summary:
            summary[kernel] = dict(ms=ms["kernel"], plain_ms=ms["plain"],
                                   bound_ms=bound[bound_by], bound_by=bound_by,
                                   library_ms=ms["library"])

    obs_flag = np.random.default_rng(0).standard_normal((256, FLAGSHIP_OBS)).astype(np.float32)
    obs_hum = np.random.default_rng(1).standard_normal((256, HUMANOID_OBS_DIM)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, agent, obs_all, batches, modes in (
        ("flagship", flagship, obs_flag, (1, 256), ("eval", "collect")),
        ("humanoid_state", humanoid, obs_hum, (8, 256), ("eval", "collect")),
    ):
        for batch in batches:
            for mode in modes:
                obs = obs_all[:batch]

                def call():
                    agent.act(obs, gen, deterministic=mode == "eval", collect=mode == "collect")

                for _ in range(WARMUP_CALLS):
                    call()
                act_ms = statistics.median(host_ms(call, TIMED_CALLS))
                log(f"[5 times] act latency {label} b={batch} {mode}: median {act_ms:.4f} ms "
                    f"over {TIMED_CALLS} calls | {card}")

    # The flagship train update, per variant: host clock (profiled_phase profiles it).
    for variant in ("v1", "v2"):
        train_cfg.tpu.denoiser_kernel = variant
        timed_state = trainer.new_train_state(304)

        def train_call():
            nonlocal timed_state
            timed_state, _ = trainer.train_step(timed_state, train_batches[0])

        for _ in range(TRAIN_WARMUP):
            train_call()
        step_ms = host_ms(train_call, TRAIN_TIMED)
        log(f"[5 times] train_step flagship {variant}-f32 B={FLAGSHIP['batch']}: median "
            f"{statistics.median(step_ms):.4f} ms over {TRAIN_TIMED} steps (min "
            f"{min(step_ms):.4f}, max {max(step_ms):.4f}; MINE every 5th) | {card}")
    train_cfg.tpu.denoiser_kernel = "v1"

    # train_epoch at the flagship, v1: the eager loop against graph replays, in turns
    epoch_times_phase(ring, epoch_pairs, card)
    t0 = time.perf_counter()
    dreamer_times_phase(dreamer, card)
    log(f"[5 times] the learning preset's times in {time.perf_counter() - t0:.1f} s")

    # 4h, with its times: the fused collect+train loop (device envs, the
    # planar engine, train_fused).
    fused = fused_phase(dev, launches)
    t0 = time.perf_counter()
    fused_times_phase(fused, FUSED_COLLECTS, {"halfcheetah_planar_fused": FUSED_CHEETAH}, card)
    log(f"[5 times] the fused loop's times in {time.perf_counter() - t0:.1f} s")

    # [4 rigid3d], with its times: the 3D engine (envs/rigid3d.py) in the fused loop.
    rigid = rigid3d_phase(dev, launches)
    fused_times_phase(rigid, RIGID3D_COLLECTS, RIGID3D_PRESETS, card)

    # [4 ground] and [4 resume]: grounded-belief training (the tuned preset), C5, and
    # train_fused's checkpoint round trip.
    ground = ground_phase(dev, launches)
    eager, eager_state, graph, graph_state = ground["pair"]
    _, _, times = epoch_times(eager, eager_state, graph, graph_state, ground["ring"].state,
                              updates=GROUND_TIMED)
    log(f"[5 times] train_epoch {TUNED} B={graph.config.batch_size} (ground_beliefs: one plain "
        f"differentiated sweep an update), {GROUND_TIMED} updates an arm in blocks of "
        f"{EPOCH_BLOCK}, in turns (eager, graph, graph, eager): eager loop median "
        f"{times['eager']['median_ms']:.4f} ms an update, {times['eager']['updates_per_s']:.3f} "
        f"updates/s; graph replays median {times['graph']['median_ms']:.4f} ms an update, "
        f"{times['graph']['updates_per_s']:.3f} updates/s "
        f"({times['graph']['updates_per_s'] / times['eager']['updates_per_s']:.2f}x) | {card}")
    r = ground["collect"]
    log(f"[5 times] fused collect {TUNED}.yaml on HalfCheetahPlanar-v0 "
        f"({r['run'].args.num_envs} envs, the sweep at K=15): {r['steps_per_s']:.1f} env steps/s "
        f"(a collect of graph replays into the ring); first collect with the capture "
        f"{r['first_s']:.3f} s, capture {r['capture_s']:.3f} s | {card}")
    resume_phase(dev, launches)

    # The profiled replays, in a process of their own (see profiled_phase).
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, str(Path(__file__).resolve()), PROFILED_FLAG],
                           timeout=PROFILED_TIMEOUT_S)
    log(f"[5 profiled] the profiled process exited {child.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    if child.returncode != 0:
        raise RuntimeError(f"the profiled process exited {child.returncode}")

    # -- 6. summary ---------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"active_inference_diffusion_torch/csrc/{KERNELS[name][2]}.cu",
        "replaces": REPLACES[name],
        "launches": launches[name],
        "max_abs_err": max_abs_err[name],
        **summary[name],
    } for name in KERNELS]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(profiled_main() if sys.argv[1:] == [PROFILED_FLAG] else main())
