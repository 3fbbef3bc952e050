"""Fused on-device training: device env rollouts, the replay ring and the
train update on one card, with no host env.

    python -m active_inference_diffusion_torch.train_fused [--config YAML]
        [--env NAME] [--num-envs 64] [--steps-per-iter 32]
        [--updates-per-iter 8] [--iterations 50] [--train-epoch]
        [--eval-every N] [--warm-start-steps K] [--device cpu]
        [--checkpoint-dir DIR [--save-replay]] [--resume DIR/best|DIR/final]

Counterpart of ``examples/train_fused.py``: ``build_run_config`` (with the
precedence ``tests/test_train_fused_config.py`` fixes), the exploration
schedule ``exploration_eps``, ``collect_and_store`` (collect with the device
envs, flatten, add to the device replay ring with the terminations only) and
the iteration loop (``train_epoch`` with ``--train-epoch``, else
``train_step`` on ``replay_sample``), with ``fused_eval`` every
``--eval-every`` iterations and a JSONL log under ``--log-dir``, and the
checkpoint flow of the JAX script (``utils/checkpoints.py``): with
``--checkpoint-dir`` a ``best`` checkpoint at each eval that beats the best
so far and a ``final`` one at the end (``--save-replay`` adds the ring to
both); with ``--resume`` the checkpoint's score-target convention adopted
before the agent is built, the agent, train state and (when saved) ring
restored, ``total_steps`` and the best eval carried on, and without a saved
ring ``--resume-refill-steps`` env steps collected by the resumed policy
with no updates. The env states and the run's generator restart from
``--seed``, as in the JAX script. Without
``--config`` it trains on Pendulum-v1 with the sweep acting; with a planar
preset (``examples/configs/*_planar_fused.yaml``) on the planar engine; with
a 3D preset (``ant3d_fused*.yaml``, ``humanoid3d_fused.yaml``,
``humanoidstandup3d_fused.yaml``) or ``--env Ant3D-v0`` on the 3D engine.
``tpu.compute_dtype`` sets the sweep's weight type only, as in the JAX
package; ``tpu.remat_score_network`` changes nothing here (in JAX a
``jax.checkpoint`` that trades memory and leaves the values equal).

It runs on the CUDA device unless ``--device cpu`` is given; there each
collect step and each eval step is a replayed CUDA graph
(``envs/collect_graph.py``) and each ``--train-epoch`` update too.
``--video-every`` raises naming ROADMAP A12.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from .agents.state_agent import DiffusionStateAgent
from .configs.config import (
    ActiveInferenceConfig,
    DiffusionConfig,
    TrainingConfig,
    load_yaml_config,
)
from .core.active_inference import resolve_device
from .data.replay import draw_indices, replay_add_batch, replay_init, replay_sample
from .envs.collect_graph import CollectGraph, EvalGraph
from .envs.device_envs import (
    ExplorationNoise,
    flatten_transitions,
    init_warm_state,
    make_device_env,
    make_rollout_policy,
    make_warm_rollout_policy,
)
from .utils.checkpoints import adopt_checkpoint_semantics, load_checkpoint, save_checkpoint
from .utils.logger import Logger

ENVS = ["Pendulum-v1", "PointMass2D-v0", "Reacher2Link-v0", "HalfCheetah-v4", "Hopper-v4",
        "Walker2d-v4", "Ant-v4", "Humanoid-v4", "HumanoidStandup-v4", "HopperPlanar-v0",
        "Walker2dPlanar-v0", "HalfCheetahPlanar-v0", "Ant3D-v0", "Humanoid3D-v0",
        "HumanoidStandup3D-v0"]


def build_run_config(args):
    """(env, env_name, config, training_config) from parsed args. With
    ``--config`` the YAML is the base: an explicit ``--env`` wins over its
    env_name and the agent-level flags are ignored; without it the flags
    build the config. ``--buffer-size`` overrides in both modes only when
    passed. The env is made on ``args.device`` (None: CUDA)."""
    device = getattr(args, "device", None)
    if args.config:
        config, training_config, _ = load_yaml_config(args.config)
        env_name = args.env or config.env_name
        env = make_device_env(env_name, device=device)
        config.observation_dim = env.observation_dim
        config.action_dim = env.action_dim
        config.env_name = env_name
    else:
        env_name = args.env or "Pendulum-v1"
        env = make_device_env(env_name, device=device)
        config = ActiveInferenceConfig(
            env_name=env_name,
            observation_dim=env.observation_dim,
            action_dim=env.action_dim,
            latent_dim=args.latent_dim,
            hidden_dim=args.hidden_dim,
            score_num_layers=args.score_layers,
            batch_size=args.batch_size,
            efe_horizon=args.efe_horizon,
            num_efe_trajectories=args.efe_trajectories,
            kl_weight=args.kl_weight,
            learning_rate=args.learning_rate,
            lambda_n_steps=args.lambda_n_steps,
            ground_beliefs=args.ground_beliefs,
            efe_value_weight=args.efe_value_weight,
            imagined_value_targets=args.imagined_value_targets,
            deterministic_beliefs=args.deterministic_beliefs,
            pragmatic_weight=args.pragmatic_weight,
            posterior_beliefs=args.posterior_beliefs,
            act_from_posterior=args.act_from_posterior,
            imagined_entropy_scale=args.entropy_scale,
            imagine_deterministic=args.imagine_deterministic,
            imagined_return_norm=not args.no_return_norm,
            value_ema_regularizer=args.value_ema_reg,
            auto_entropy=args.auto_entropy,
            entropy_target=args.entropy_target,
            imagined_reward_pessimism=args.reward_pessimism,
            imagined_reward_clip=args.imagined_reward_clip,
            policy_lr_scale=args.policy_lr_scale,
            policy_anchor_weight=args.policy_anchor_weight,
            policy_anchor_warmup_steps=args.policy_anchor_warmup,
            num_dynamics_ensemble=args.dynamics_ensemble,
            ensemble_pessimism=args.ensemble_pessimism,
            predict_continuation=args.predict_continuation,
            diffusion=DiffusionConfig(num_diffusion_steps=args.diffusion_steps,
                                      beta_schedule="cosine"),
        )
        config.semantics.score_target_convention = args.score_target
        training_config = TrainingConfig(buffer_size=50_000)
    if args.buffer_size is not None:
        training_config.buffer_size = args.buffer_size
    return env, env_name, config, training_config


def exploration_eps(training_config: TrainingConfig, steps: int) -> float:
    """The host collector's eps(t): it decays once per collect iteration of
    ``num_parallel_envs`` env steps, so the same YAML gives the same
    schedule in env steps; 0 where ``exploration_noise`` is 0."""
    tc = training_config
    if tc.exploration_noise <= 0.0:
        return 0.0
    unit = max(1, tc.num_parallel_envs)
    return max(tc.min_exploration, tc.exploration_noise * tc.exploration_decay ** (steps / unit))


def collect_and_store(agent, state, collector: CollectGraph, replay, env_states, policy_state,
                      generator: torch.Generator, eps: Optional[float] = None):
    """One collect with the modules ``agent.acting_modules(state)`` names,
    its transitions flattened into the replay ring (``dones`` the
    terminations only: time-limit truncation counts as continuing). ``eps``
    is written into the collect policy's exploration scale where it has
    one. Returns (env_states, policy_state, the mean step reward as a 0-d
    device tensor)."""
    if eps is not None and isinstance(collector.policy, ExplorationNoise):
        collector.policy.eps.fill_(eps)
    with agent.core.swapped(agent.acting_modules(state)):
        transitions, env_states, policy_state = collector.collect(env_states, policy_state,
                                                                  generator)
    flat = flatten_transitions(transitions)
    replay_add_batch(replay, flat.observations, flat.actions, flat.rewards,
                     flat.next_observations, flat.terminateds)
    return env_states, policy_state, torch.mean(flat.rewards)


def train_updates(agent, state, replay, updates: int, train_epoch: bool):
    """``updates`` train updates on the ring: one ``train_epoch`` call, or
    ``train_step`` on ``replay_sample`` with the ring indices drawn from the
    state's generator. Returns (state, the last update's or the epoch's
    mean metrics)."""
    if train_epoch:
        return agent.train_epoch(state, replay, updates)
    metrics = {}
    for _ in range(updates):
        indices = draw_indices(replay, agent.config.batch_size, state.rng)
        state, metrics = agent.train_step(state, replay_sample(replay, indices))
    return state, metrics


def eval_return(agent, state, evaluator: EvalGraph, generator: torch.Generator) -> torch.Tensor:
    """``fused_eval`` with the acting modules: the mean return of one
    deterministic episode per eval env."""
    with agent.core.swapped(agent.acting_modules(state)):
        return evaluator.evaluate(generator)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--env", default=None, choices=ENVS,
                   help="defaults to the YAML's env_name with --config, else Pendulum-v1")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--num-envs", type=int, default=64)
    p.add_argument("--steps-per-iter", type=int, default=32)
    p.add_argument("--updates-per-iter", type=int, default=8)
    p.add_argument("--iterations", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ground-beliefs", action="store_true")
    p.add_argument("--lambda-n-steps", type=int, default=5)
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--efe-value-weight", type=float, default=1.0)
    p.add_argument("--imagined-value-targets", action="store_true")
    p.add_argument("--deterministic-beliefs", action="store_true")
    p.add_argument("--pragmatic-weight", type=float, default=1.0)
    p.add_argument("--posterior-beliefs", action="store_true")
    p.add_argument("--act-from-posterior", action="store_true")
    p.add_argument("--entropy-scale", type=float, default=3e-4)
    p.add_argument("--imagine-deterministic", action="store_true")
    p.add_argument("--train-epoch", action="store_true",
                   help="each iteration's updates as one train_epoch (graph replays on the card)")
    p.add_argument("--buffer-size", type=int, default=None)
    p.add_argument("--score-target", default=None, choices=["reference", "standard"])
    p.add_argument("--warm-start-steps", type=int, default=0,
                   help="collect with warm-start partial denoising of N reverse steps")
    p.add_argument("--eval-every", type=int, default=0)
    p.add_argument("--eval-envs", type=int, default=64)
    p.add_argument("--no-return-norm", action="store_true")
    p.add_argument("--value-ema-reg", type=float, default=1.0)
    p.add_argument("--auto-entropy", action="store_true")
    p.add_argument("--entropy-target", type=float, default=None)
    p.add_argument("--reward-pessimism", type=float, default=0.0)
    p.add_argument("--dynamics-ensemble", type=int, default=1)
    p.add_argument("--ensemble-pessimism", type=float, default=0.0)
    p.add_argument("--predict-continuation", action="store_true")
    p.add_argument("--latent-dim", type=int, default=16)
    p.add_argument("--hidden-dim", type=int, default=64)
    p.add_argument("--score-layers", type=int, default=2)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--efe-horizon", type=int, default=3)
    p.add_argument("--efe-trajectories", type=int, default=4)
    p.add_argument("--diffusion-steps", type=int, default=10)
    p.add_argument("--kl-weight", type=float, default=0.1)
    p.add_argument("--policy-lr-scale", type=float, default=1.0)
    p.add_argument("--imagined-reward-clip", type=float, default=0.0)
    p.add_argument("--policy-anchor-weight", type=float, default=0.0)
    p.add_argument("--policy-anchor-warmup", type=int, default=0)
    p.add_argument("--config", default=None,
                   help="YAML config; the agent-level flags above are then ignored")
    p.add_argument("--log-dir", default="logs")
    p.add_argument("--checkpoint-dir", default=None,
                   help="save a 'best' checkpoint whenever the eval improves and a 'final' one "
                        "at the end (requires --eval-every)")
    p.add_argument("--resume", default=None,
                   help="checkpoint (dir, or dir/best) to restore the train state from; the step "
                        "count and the best eval continue from its meta, a ring saved with "
                        "--save-replay is restored, else the ring refills first")
    p.add_argument("--save-replay", action="store_true",
                   help="checkpoint the device replay ring too")
    p.add_argument("--resume-refill-steps", type=int, default=8192,
                   help="on --resume without a saved ring, collect this many env steps with "
                        "the resumed policy (no updates) before training (0 = off)")
    p.add_argument("--video-every", type=int, default=0)
    args = p.parse_args(argv)
    if args.checkpoint_dir and not args.eval_every:
        p.error("--checkpoint-dir requires --eval-every (best-eval saves)")
    return args


def check_flags(args) -> None:
    """Raise for the JAX script's flags this port does not have yet."""
    if args.video_every:
        raise NotImplementedError("--video-every: the episode renderer is not ported yet "
                                  "(ROADMAP A12)")


@dataclass
class FusedRun:
    """Everything ``main``'s loop works on, as ``build_run`` makes it."""

    args: argparse.Namespace
    env: object
    env_name: str
    agent: DiffusionStateAgent
    state: object
    replay: object
    collector: CollectGraph
    evaluator: Optional[EvalGraph]
    generator: torch.Generator
    env_states: object
    policy_state: object = None
    total_steps: int = 0
    best_eval: float = float("-inf")
    restored_replay: bool = False


def build_run(args) -> FusedRun:
    """The env, agent (initialised from ``args.seed``), ring, collect and
    eval loops, generator and first env states of a run; with
    ``--resume`` the checkpoint's convention adopted first, then its agent,
    train state and ring (when saved) restored, and its step count and best
    eval carried on."""
    check_flags(args)
    device = resolve_device(args.device)
    args.device = device
    env, env_name, config, training_config = build_run_config(args)
    if args.resume:  # before the agent: its update takes the convention
        adopt_checkpoint_semantics(args.resume, config)
    agent = DiffusionStateAgent(env.observation_dim, env.action_dim, config, training_config,
                                device=device)
    agent.check_train_supported()
    state = agent.init_train_state(args.seed)
    replay = replay_init(training_config.buffer_size, (env.observation_dim,), env.action_dim,
                         device=device)
    meta, restored = {}, False
    if args.resume:
        state, meta = load_checkpoint(args.resume, agent, state, replay_template=replay)
        restored = meta.pop("replay_state", None) is not None
        print(f"resumed from {args.resume}: total_steps={meta.get('total_steps')} "
              f"eval_return={meta.get('eval_return')} replay="
              f"{f'restored (size {replay.host_size})' if restored else 'fresh'}", flush=True)
    if args.warm_start_steps:
        if config.act_from_posterior:
            raise SystemExit("--warm-start-steps is meaningless with act_from_posterior "
                             "(no sweep to truncate)")
        policy = make_warm_rollout_policy(agent.core, env, num_steps=args.warm_start_steps,
                                          deterministic_beliefs=config.deterministic_beliefs)
    else:
        policy = make_rollout_policy(agent.core, env, act_from_posterior=config.act_from_posterior,
                                     deterministic_beliefs=config.deterministic_beliefs)
    if training_config.exploration_noise > 0.0:
        policy = ExplorationNoise(policy, env, torch.zeros((), device=device))
    evaluator = None
    if args.eval_every:
        evaluator = EvalGraph(env, make_rollout_policy(
            agent.core, env, deterministic=True, act_from_posterior=config.act_from_posterior),
            args.eval_envs)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    env_states = env.reset(env.draw_reset(args.num_envs, generator))
    policy_state = None
    if args.warm_start_steps:
        policy_state = init_warm_state(args.num_envs, config.latent_dim, generator)
    best = meta.get("eval_return")
    return FusedRun(args, env, env_name, agent, state, replay,
                    CollectGraph(env, policy, args.num_envs, args.steps_per_iter), evaluator,
                    generator, env_states, policy_state,
                    total_steps=int(meta.get("total_steps", 0)),
                    best_eval=float("-inf") if best is None else float(best),
                    restored_replay=restored)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def iterate(run: FusedRun, it: int) -> dict:
    """Iteration ``it`` of the loop: ``collect_and_store`` at the step's
    exploration scale, then, once the ring holds a batch,
    ``--updates-per-iter`` updates, and on the eval iterations
    ``eval_return``. Returns the iteration's log: the mean step reward, the
    exploration scale, the update metrics, env steps/s of the iteration and
    of the collect alone, updates/s, and the eval return."""
    args, agent = run.args, run.agent
    tc = agent.training_config
    dev = agent.device
    t0 = time.perf_counter()
    eps = exploration_eps(tc, run.total_steps)
    run.env_states, run.policy_state, mean_reward = collect_and_store(
        agent, run.state, run.collector, run.replay, run.env_states, run.policy_state,
        run.generator, eps)
    _sync(dev)
    t1 = time.perf_counter()
    steps = args.num_envs * args.steps_per_iter
    run.total_steps += steps
    metrics = {}
    if run.replay.host_size >= agent.config.batch_size:
        run.state, metrics = train_updates(agent, run.state, run.replay, args.updates_per_iter,
                                           args.train_epoch)
    log = {"fused/mean_step_reward": float(mean_reward),
           **({"fused/exploration_eps": eps} if tc.exploration_noise > 0.0 else {}),
           **{k: float(v) for k, v in metrics.items()}}
    t2 = time.perf_counter()
    log["fused/env_steps_per_sec"] = steps / (t2 - t0)
    log["fused/collect_env_steps_per_sec"] = steps / (t1 - t0)
    if metrics:
        log["fused/updates_per_sec"] = args.updates_per_iter / (t2 - t1)
    if run.evaluator is not None and (it % args.eval_every == 0 or it == args.iterations - 1):
        log["fused/eval_return"] = float(eval_return(agent, run.state, run.evaluator,
                                                     run.generator))
        if args.checkpoint_dir and log["fused/eval_return"] > run.best_eval:
            run.best_eval = log["fused/eval_return"]
            save(run, "best")
    return log


def save(run: FusedRun, name: str) -> str:
    """The run's ``name`` checkpoint under ``--checkpoint-dir``, with the
    ring under ``--save-replay`` and the best eval and env in its meta."""
    args, agent = run.args, run.agent
    return save_checkpoint(
        args.checkpoint_dir, agent, run.state, step=run.total_steps, config=agent.config,
        training_config=agent.training_config, keep_latest_alias=False, name=name,
        replay_state=run.replay if args.save_replay else None,
        extra_meta={"eval_return": run.best_eval, "env": run.env_name})


def refill(run: FusedRun) -> None:
    """After a resume without a saved ring: collect with the resumed policy,
    no updates, until the ring holds ``--resume-refill-steps`` (at most its
    capacity) env steps."""
    target = min(run.args.resume_refill_steps, run.agent.training_config.buffer_size)
    print(f"resume refill: collecting ~{target} env steps (no updates)", flush=True)
    while run.replay.host_size < target:
        run.env_states, run.policy_state, _ = collect_and_store(
            run.agent, run.state, run.collector, run.replay, run.env_states, run.policy_state,
            run.generator, exploration_eps(run.agent.training_config, run.total_steps))
        run.total_steps += run.args.num_envs * run.args.steps_per_iter


def train(run: FusedRun) -> FusedRun:
    """The run's loop: the refill after a resume without a saved ring,
    ``--iterations`` iterations logged to ``--log-dir``, and the ``final``
    checkpoint."""
    args = run.args
    logger = Logger(experiment_name=f"fused_{run.env_name}", log_dir=args.log_dir)
    if args.resume and not run.restored_replay and args.resume_refill_steps:
        refill(run)
    for it in range(args.iterations):
        log = iterate(run, it)
        logger.log(log, run.total_steps)
        eval_str = (f" eval_return={log['fused/eval_return']:.1f}"
                    if "fused/eval_return" in log else "")
        if it % 10 == 0 or it == args.iterations - 1 or eval_str:
            print(f"[iter {it}] steps={run.total_steps} "
                  f"mean_step_reward={log['fused/mean_step_reward']:.3f} "
                  f"steps/s={log['fused/env_steps_per_sec']:.0f}" + eval_str, flush=True)
    if args.checkpoint_dir:  # whatever the evals: a run that never beat its best resumes too
        save(run, "final")
        print(f"final checkpoint saved at step {run.total_steps}", flush=True)
    return run


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    run = build_run(args)
    config = run.agent.config
    print(f"fused training: env={run.env_name} obs={run.env.observation_dim} "
          f"act={run.env.action_dim} latent={config.latent_dim} hidden={config.hidden_dim} "
          f"ensemble={config.num_dynamics_ensemble} device={args.device}", flush=True)
    train(run)
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
