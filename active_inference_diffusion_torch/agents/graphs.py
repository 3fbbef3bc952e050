"""Train updates captured in CUDA graphs: ``train_epoch`` on the card.

The torch counterpart of the JAX ``train_epoch``'s ``lax.scan`` over donated
state (``active_inference_diffusion_tpu/agents/base.py:187-200``). One
update (the batch's gather from the ring, ``train_step_from_draws``, and
the copy of every state field it reassigns back into its own tensor) is
captured once and replayed per update, so an update costs one graph launch
and its draws instead of some 5,000 kernel launches from Python.

- One graph per kind of update, the kind being what ``update_kind``
  decides on the host step count: whether the MINE update runs (``step %
  epistemic_update_every``, as JAX's ``lax.cond`` chooses) and whether the
  policy anchor is past its warm-up (JAX multiplies it by a gate traced on
  the step). A scheduled learning rate (``policy_lr_decay_steps``) is a
  device tensor the update computes from AdamW's device-side count, so one
  graph serves every step of the decay. Each is captured when its first
  update comes, and all share one memory pool.
  Parameters, optimizer moments, the train state's tensors, the ring and
  the metric sums live outside it.
- The draws of each update are made outside the graph from ``state.rng``
  (``draw_update``: the ring indices, then ``draw_train``) into the graph's
  static buffers, so a replay sees the numbers the eager loop would.
- Before a capture, one update of its kind runs on a side stream (the
  kernel build, cluster checks, the layout order, cuBLAS handles, both
  autograd passes of the gradient penalty) and is then undone: every
  tensor it changed is restored, and the host counts with it.
- Host counts a replay cannot move are moved here per replay: the train
  state's step, each optimizer's update count, and the sweep kernels'
  ``LAUNCHES`` (and ``PLAIN_RUNS``), which count host calls, by what the
  capture recorded.
- The weight pack is rebuilt inside the graph from the live parameters
  (``packed_trunk_weights`` never caches while capturing), and
  ``train_epoch`` drops the cached packs afterwards.
- A capture that fails raises; nothing falls back to the eager loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ..data.replay import ReplayState, draw_indices, replay_sample
from ..ops.denoise import LAUNCHES, PLAIN_RUNS


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a record of draws (nested NamedTuples and tuples,
    None allowed), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _tensors(x)]
    return []


def on_side_stream(fn: Callable, device: torch.device):
    """``fn()`` on a new side stream that waits for the current one and
    that the current one then waits for (the warm-up before a capture).
    Returns what ``fn`` returns."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            return fn()
    finally:
        torch.cuda.current_stream(device).wait_stream(side)


@contextlib.contextmanager
def collector_off():
    """Python's cyclic garbage collector held off. A dead cycle that holds
    a CUDA graph (an agent or a collector no longer used, say) may be freed
    whenever the collector runs, and a graph destroyed while a stream
    captures invalidates that capture; so no collection during one."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def capture_counted(graph: torch.cuda.CUDAGraph, fn: Callable, pool=None
                    ) -> Tuple[Dict[str, int], Dict[str, int]]:
    """Captures ``fn()`` into ``graph`` (in ``pool``), the collector off.
    Returns what the capture added to ``LAUNCHES`` and to ``PLAIN_RUNS``,
    which is what each replay launches, and leaves both counts as they
    were before it."""
    counts = (dict(LAUNCHES), dict(PLAIN_RUNS))
    try:
        with collector_off(), torch.cuda.graph(graph, pool=pool):
            fn()
    finally:
        deltas = tuple({n: now[n] - before[n] for n in now if now[n] != before[n]}
                       for now, before in zip((LAUNCHES, PLAIN_RUNS), counts))
        LAUNCHES.update(counts[0])
        PLAIN_RUNS.update(counts[1])
    return deltas


def count_replay(launch_deltas: Dict[str, int], plain_deltas: Dict[str, int]) -> None:
    """Adds one replay's kernel launches and plain sweeps to the host counts."""
    for name, n in launch_deltas.items():
        LAUNCHES[name] += n
    for name, n in plain_deltas.items():
        PLAIN_RUNS[name] += n


def _state_tensors(agent, state) -> List[torch.Tensor]:
    """Every tensor an update reads or writes in place, but the ring's and
    the draws': the parameters, the optimizers' moments, counts and
    scheduled rates, the EMAs (score, slow critic, policy), the return scale
    and log_alpha, and the train state's reassigned fields."""
    out = list(agent.core.parameters())
    for opt in state.optimizers.values():
        for p in opt.params:
            out += [v for v in opt.adamw.state[p].values() if isinstance(v, torch.Tensor)]
        if opt.lr is not None:
            out.append(opt.lr)
    for ema in (state.ema_score, state.target_value, state.ema_policy or {}):
        out += list(ema.values())
    norm = state.reward_norm
    return out + [state.return_scale, state.log_alpha, state.time_importance,
                  state.epistemic_running_mean, norm.mean, norm.var, norm.count,
                  state.preference_temperature]


@torch.no_grad()
def _restore(tensors: List[torch.Tensor], saved: List[torch.Tensor]) -> None:
    torch._foreach_copy_(tensors, saved)


class _Captured:
    """One update of one kind captured in a graph, with its static inputs
    and what a replay must add to the host counts."""

    def __init__(self, graph, indices, draws, step_deltas, launch_deltas, plain_deltas):
        self.graph = graph
        self.indices = indices
        self.draws = _tensors(draws)
        self.step_deltas = step_deltas  # optimizer name -> updates per replay
        self.launch_deltas = launch_deltas
        self.plain_deltas = plain_deltas


class EpochGraphs:
    """The captured updates of one agent, for one train state, ring, batch
    size and configuration; captured anew when any of them changes."""

    def __init__(self, agent):
        self.agent = agent
        self.key = None
        self.captured: Dict[tuple, _Captured] = {}  # by update_kind
        self.sums: Optional[Dict[str, torch.Tensor]] = None
        self.pool = None
        self.captures = 0  # graphs captured over the agent's life

    def _key(self, state, replay_state: ReplayState, batch_size: int):
        ring = [getattr(replay_state, f) for f in
                ("observations", "actions", "rewards", "next_observations", "dones")]
        return (batch_size, repr(self.agent.config), torch.backends.cuda.matmul.allow_tf32,
                tuple(t.data_ptr() for t in _state_tensors(self.agent, state) + ring))

    def run(self, state, replay_state: ReplayState, batch_size: int, updates: int
            ) -> Dict[str, torch.Tensor]:
        """``updates`` updates of ``state``, each a graph replay; returns
        the sums of their metrics (the graphs' own buffers, overwritten by
        the next call)."""
        agent = self.agent
        key = self._key(state, replay_state, batch_size)
        if key != self.key:
            self.captured, self.sums, self.key = {}, None, key
            self.pool = torch.cuda.graph_pool_handle()
        if self.sums is not None:
            torch._foreach_zero_(list(self.sums.values()))
        for _ in range(updates):
            kind = agent.update_kind(state.step)
            if kind not in self.captured:
                self.captured[kind] = self._capture(state, replay_state, batch_size)
            run = self.captured[kind]
            draw_indices(replay_state, batch_size, state.rng, out=run.indices)
            torch._foreach_copy_(run.draws, _tensors(agent.draw_train(state, batch_size)))
            run.graph.replay()
            state.step += 1
            for name, n in run.step_deltas.items():
                state.optimizers[name].count += n
            count_replay(run.launch_deltas, run.plain_deltas)
        return self.sums

    def _update(self, state, replay_state, indices, draws, sums) -> None:
        """One update whose results land in tensors that exist before it:
        the fields ``train_step_from_draws`` reassigns are copied back into
        their own tensors, the metrics added into ``sums``."""
        fixed = (state.time_importance, state.reward_norm, state.epistemic_running_mean)
        batch = replay_sample(replay_state, indices)
        state, metrics = self.agent.train_step_from_draws(state, batch, draws)
        pairs = [(fixed[0], state.time_importance), (fixed[2], state.epistemic_running_mean)]
        pairs += [(getattr(fixed[1], f), getattr(state.reward_norm, f))
                  for f in ("mean", "var", "count")]
        for old, new in pairs:
            if new is not old:
                old.copy_(new)
        state.time_importance, state.reward_norm, state.epistemic_running_mean = fixed
        torch._foreach_add_(list(sums.values()), [metrics[k] for k in sums])

    def _capture(self, state, replay_state, batch_size) -> _Captured:
        """Warm up one update of the current step's kind on a side stream,
        undo it, then capture it into the shared pool."""
        agent = self.agent
        probe = torch.Generator(device=agent.device)
        probe.set_state(state.rng.get_state())
        indices, draws = agent.draw_update(dataclasses.replace(state, rng=probe), replay_state,
                                           batch_size)
        tensors = _state_tensors(agent, state)
        saved = [t.detach().clone() for t in tensors]
        host = (state.step, {name: opt.count for name, opt in state.optimizers.items()})

        def reset_host() -> None:
            state.step = host[0]
            for name, opt in state.optimizers.items():
                opt.count = host[1][name]

        try:  # the warm-up's launches stay counted
            warm_state, metrics = on_side_stream(lambda: agent.train_step_from_draws(
                dataclasses.replace(state), replay_sample(replay_state, indices), draws),
                agent.device)
            steps = {name: opt.count - host[1][name] for name, opt in warm_state.optimizers.items()}
        finally:
            _restore(tensors, saved)
            reset_host()
        if self.sums is None:
            self.sums = {k: torch.zeros_like(v) for k, v in metrics.items()}
        graph = torch.cuda.CUDAGraph()
        try:
            launch_deltas, plain_deltas = capture_counted(
                graph, lambda: self._update(state, replay_state, indices, draws, self.sums),
                self.pool)
        finally:
            reset_host()
        self.captures += 1
        return _Captured(graph, indices, draws, {n: k for n, k in steps.items() if k},
                         launch_deltas, plain_deltas)
