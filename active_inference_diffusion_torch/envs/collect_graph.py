"""The fused collect and eval on the card: one env step captured in a CUDA
graph, replayed once a step.

The torch counterpart of the JAX ``lax.scan`` over env steps in
``fused_collect_stateful`` and ``fused_eval``
(``active_inference_diffusion_tpu/envs/jax_envs.py:326-441``). Capturing
the whole collect would make a graph of hundreds of thousands of nodes on
the planar tasks, so one batched env step is captured and replayed T times:

- the step holds the rollout policy (the sweep kernel inside it where the
  policy acts by the sweep), the exploration noise, the physics, the
  autoreset and the writing of the step's transition into the collect's
  (T, N, ...) buffers at a step index the graph keeps on the device;
- the draws are made outside the graph, per step in ``draw_step``'s
  order, and copied into its static buffers, so a replay sees the numbers
  the eager loop would; the exploration scale is a device tensor the host
  writes (``ExplorationNoise.eps``), the warm-start belief a static tensor;
- the first step of the first collect runs eagerly on a side stream (the
  kernel build, cuBLAS handles), then the step is captured (and the
  capture timed); the sweep
  kernels' ``LAUNCHES`` and ``PLAIN_RUNS``, which count host calls, are
  moved per replay by what the capture recorded, so each env step counts
  once;
- the graph is captured anew when the acting modules' parameters move to
  other tensors (``core.swapped`` with other EMA modules), and replays read
  the weights in place, so training between collects needs no recapture
  (the sweep's weight pack is gathered inside the graph);
- a capture that fails raises; nothing falls back to the eager loop.

On the CPU the same steps run eagerly (``fused_collect_stateful``,
``fused_eval`` of ``device_envs.py``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch

from ..agents.graphs import _tensors, capture_counted, count_replay, on_side_stream
from .device_envs import (
    DeviceEnv,
    EnvState,
    Transitions,
    collect_step,
    draw_collect,
    draw_eval,
    draw_step,
    eval_step,
    fused_collect_stateful,
    fused_eval,
    stateful,
)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        items = [_clone(x) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


class StepGraph:
    """One step function over static tensors: run eagerly once on a side
    stream, then captured; later calls replay it. Keeps what a replay must
    add to the host launch counts."""

    def __init__(self, step: Callable[[], None], device: torch.device):
        self.step, self.device = step, device
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launch_deltas: Dict[str, int] = {}
        self.plain_deltas: Dict[str, int] = {}
        self.capture_seconds = 0.0
        self.replays = 0

    def __call__(self) -> None:
        if self.graph is None:
            self._first()
            return
        self.graph.replay()
        self.replays += 1
        count_replay(self.launch_deltas, self.plain_deltas)

    def _first(self) -> None:
        on_side_stream(self.step, self.device)  # a real step: its launches stay counted
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            self.launch_deltas, self.plain_deltas = capture_counted(graph, self.step)
        except Exception as exc:
            raise RuntimeError(f"capturing the env step failed: {exc}") from exc
        torch.cuda.synchronize(self.device)
        self.capture_seconds = time.perf_counter() - t0
        self.graph = graph


def _acting_key(policy) -> tuple:
    core = getattr(policy, "core", None)
    inner = getattr(policy, "policy", None)
    if core is None and inner is not None:
        core = getattr(inner, "core", None)
    params = () if core is None else tuple(p.data_ptr() for p in core.parameters())
    return params, torch.backends.cuda.matmul.allow_tf32


class CollectGraph:
    """``num_steps`` env steps of ``num_envs`` envs with ``policy`` (an
    object with ``draw(n, generator)`` and ``__call__``, stateful or not),
    each step a replay of one captured step on the card, or the eager step
    on the CPU. ``collect`` returns the transitions (T, N, ...), the env
    states and the policy state; on the card they are the graph's own
    buffers, overwritten by the next collect."""

    def __init__(self, env: DeviceEnv, policy, num_envs: int, num_steps: int):
        self.env, self.policy = env, policy
        self.num_envs, self.num_steps = num_envs, num_steps
        self.policy_fn = policy if getattr(policy, "stateful", False) else stateful(policy)
        self.on_card = env.device.type == "cuda"
        self.step_graph: Optional[StepGraph] = None
        self.key = None
        self.captures = 0

    def collect(self, env_states: EnvState, policy_state, generator: torch.Generator
                ) -> Tuple[Transitions, EnvState, object]:
        if not self.on_card:
            draws = draw_collect(self.env, self.policy, self.num_envs, self.num_steps, generator,
                                 reset=False)
            return fused_collect_stateful(self.env, self.policy_fn, draws, policy_state,
                                          env_states)
        for t in range(self.num_steps):
            draws = draw_step(self.env, self.policy, self.num_envs, generator)
            if t == 0:
                self._prepare(env_states, policy_state, draws)
                self.t.zero_()
            torch._foreach_copy_(_tensors(self.draws), _tensors(draws))
            self.step_graph()
        return self.out, self.state, self.pstate

    def _prepare(self, env_states: EnvState, policy_state, draws) -> None:
        key = _acting_key(self.policy)
        if self.step_graph is None or key != self.key:
            self.key = key
            self.state = EnvState(*[t.clone() for t in env_states.tensors()])
            self.pstate = _clone(policy_state)
            self.draws = _clone(draws)
            self.t = torch.zeros((), dtype=torch.int64, device=self.env.device)
            obs, n, dev = self.state.obs, self.num_envs, self.env.device
            shapes = [(obs.shape, obs.dtype), ((n, self.env.action_dim), torch.float32),
                      ((n,), self.state.reward.dtype), (obs.shape, obs.dtype),
                      ((n,), torch.bool), ((n,), torch.bool)]
            self.out = Transitions(*[torch.empty((self.num_steps,) + tuple(shape), dtype=dtype,
                                                 device=dev) for shape, dtype in shapes])
            self.step_graph = StepGraph(self._step, self.env.device)
            self.captures += 1
            return
        if env_states.physics is not self.state.physics:
            torch._foreach_copy_(self.state.tensors(), env_states.tensors())
        if isinstance(policy_state, torch.Tensor) and policy_state is not self.pstate:
            self.pstate.copy_(policy_state)

    def _step(self) -> None:
        state, pstate, tr = collect_step(self.env, self.policy_fn, self.state, self.pstate,
                                         self.draws)
        index = self.t.view(1)
        for buf, value in zip(self.out, tr):
            buf.index_copy_(0, index, value.unsqueeze(0).to(buf.dtype))
        torch._foreach_copy_(self.state.tensors(), state.tensors())
        if isinstance(pstate, torch.Tensor):
            self.pstate.copy_(pstate)
        self.t.add_(1)


class EvalGraph:
    """``fused_eval`` with ``policy`` (stateless) over ``num_envs`` fresh
    episodes of ``num_steps`` steps at most (None: the env's
    ``max_episode_steps``): the reset eager, then each step a replay of one
    captured eval step on the card, or the eager step on the CPU. Returns
    the mean return as a 0-d device tensor."""

    def __init__(self, env: DeviceEnv, policy, num_envs: int, num_steps: Optional[int] = None):
        self.env, self.policy, self.num_envs = env, policy, num_envs
        self.num_steps = env.max_episode_steps if num_steps is None else num_steps
        self.on_card = env.device.type == "cuda"
        self.step_graph: Optional[StepGraph] = None
        self.key = None

    def evaluate(self, generator: torch.Generator) -> torch.Tensor:
        env, n = self.env, self.num_envs
        if not self.on_card:
            return fused_eval(env, self.policy, draw_eval(env, self.policy, n, self.num_steps,
                                                          generator))
        state = env.reset(env.draw_reset(n, generator))
        total = torch.zeros(n, device=env.device)
        alive = torch.ones(n, device=env.device)
        for t in range(self.num_steps):
            draws = self.policy.draw(n, generator)
            if t == 0:
                key = _acting_key(self.policy)
                if self.step_graph is None or key != self.key:
                    self.key = key
                    self.state = EnvState(*[x.clone() for x in state.tensors()])
                    self.total, self.alive = total.clone(), alive.clone()
                    self.draws = _clone(draws)
                    self.step_graph = StepGraph(self._step, env.device)
                else:
                    torch._foreach_copy_(self.state.tensors() + [self.total, self.alive],
                                         state.tensors() + [total, alive])
            torch._foreach_copy_(_tensors(self.draws), _tensors(draws))
            self.step_graph()
        return torch.mean(self.total)

    def _step(self) -> None:
        state, total, alive = eval_step(self.env, self.policy, self.state, self.total, self.alive,
                                        self.draws)
        torch._foreach_copy_(self.state.tensors() + [self.total, self.alive],
                             state.tensors() + [total, alive])
