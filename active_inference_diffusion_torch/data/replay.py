"""Replay buffers: a ring of device tensors, and a host (numpy) ring.

Counterpart of ``active_inference_diffusion_tpu/data/replay.py``:
``ReplayState`` / ``replay_init`` / ``replay_add_batch`` / ``replay_sample``
(:28-97), ``DeviceReplayBuffer`` (:100-145), ``_sample_indices`` and
``HostReplayBuffer`` (:148-226).

- ``ReplayState`` holds every transition in device tensors. ``pos`` and
  ``size`` are 0-d int64 tensors, as the JAX state's scalars, with host
  mirrors (``host_pos``, ``host_size``) so that adding and drawing indices
  never read the device. ``replay_add_batch`` writes in place at
  ``(pos + arange(n)) % capacity`` and wraps.
- ``replay_sample(state, indices)`` is the gather; the indices are drawn
  apart (``draw_indices``, uniform over ``[0, size)`` from an explicit
  generator), so a train update can take them from its own generator and a
  captured update can read them from a static buffer. uint8 observations
  decode to float32 in [0, 1].
- ``HostReplayBuffer`` keeps numpy arrays and returns tensors on its
  device; ``_sample_indices`` gives the JAX package's integers for a host
  seed.
- ``CompressedReplayBuffer`` needs a copy of the native LZ4 codec and comes
  with the pixel slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.active_inference import resolve_device

_FIELDS = ("observations", "actions", "rewards", "next_observations", "dones")


@dataclass
class ReplayState:
    observations: torch.Tensor  # (N, *obs_shape)
    actions: torch.Tensor  # (N, A)
    rewards: torch.Tensor  # (N,)
    next_observations: torch.Tensor  # (N, *obs_shape)
    dones: torch.Tensor  # (N,) bool
    pos: torch.Tensor  # 0-d int64, the next write index
    size: torch.Tensor  # 0-d int64, the current fill
    host_pos: int = 0
    host_size: int = 0

    @property
    def capacity(self) -> int:
        return self.observations.shape[0]


def replay_init(
    capacity: int,
    obs_shape: Tuple[int, ...],
    action_dim: int,
    obs_dtype: torch.dtype = torch.float32,
    device=None,
) -> ReplayState:
    """An empty ring of ``capacity`` transitions on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    return ReplayState(
        observations=torch.zeros((capacity,) + tuple(obs_shape), dtype=obs_dtype, device=dev),
        actions=torch.zeros((capacity, action_dim), device=dev),
        rewards=torch.zeros((capacity,), device=dev),
        next_observations=torch.zeros((capacity,) + tuple(obs_shape), dtype=obs_dtype,
                                      device=dev),
        dones=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        pos=torch.zeros((), dtype=torch.int64, device=dev),
        size=torch.zeros((), dtype=torch.int64, device=dev),
    )


def replay_add_batch(
    state: ReplayState,
    obs: torch.Tensor,
    actions: torch.Tensor,
    rewards: torch.Tensor,
    next_obs: torch.Tensor,
    dones: torch.Tensor,
) -> ReplayState:
    """Insert a batch of transitions at the ring position, in place; the
    arguments are cast to the ring's types on its device. Returns
    ``state``."""
    n = obs.shape[0]
    cap = state.capacity
    dev = state.observations.device
    idx = (torch.arange(n, device=dev) + state.host_pos) % cap
    for name, value in zip(_FIELDS, (obs, actions, rewards, next_obs, dones)):
        buf = getattr(state, name)
        buf[idx] = torch.as_tensor(value).to(device=dev, dtype=buf.dtype)
    state.host_pos = (state.host_pos + n) % cap
    state.host_size = min(state.host_size + n, cap)
    state.pos.fill_(state.host_pos)
    state.size.fill_(state.host_size)
    return state


def draw_indices(
    state: ReplayState, batch_size: int, generator: torch.Generator,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``batch_size`` indices uniform over ``[0, max(size, 1))`` from
    ``generator`` (on the ring's device), by the host mirror of ``size``;
    into ``out`` when given."""
    high = max(state.host_size, 1)
    if out is not None:
        return torch.randint(0, high, (batch_size,), generator=generator, out=out)
    return torch.randint(0, high, (batch_size,), generator=generator,
                         device=state.observations.device)


def replay_sample(state: ReplayState, indices: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The transitions at ``indices``; uint8 observations decode to float32
    in [0, 1]."""
    obs = state.observations[indices]
    next_obs = state.next_observations[indices]
    if obs.dtype == torch.uint8:
        obs = obs.to(torch.float32) / 255.0
        next_obs = next_obs.to(torch.float32) / 255.0
    return {
        "observations": obs,
        "actions": state.actions[indices],
        "rewards": state.rewards[indices],
        "next_observations": next_obs,
        "dones": state.dones[indices],
    }


class DeviceReplayBuffer:
    """Stateful wrapper over the ``ReplayState`` functions, with the
    reference's ReplayBuffer API (add / sample / __len__)."""

    def __init__(
        self,
        capacity: int,
        obs_shape: Tuple[int, ...],
        action_dim: int,
        obs_dtype: torch.dtype = torch.float32,
        device=None,
    ):
        self.capacity = capacity
        self.state = replay_init(capacity, obs_shape, action_dim, obs_dtype, device)

    def add(self, obs, action, reward, next_obs, done):
        self.add_batch(
            np.asarray(obs)[None],
            np.asarray(action)[None],
            np.asarray([reward]),
            np.asarray(next_obs)[None],
            np.asarray([done]),
        )

    def add_batch(self, obs, actions, rewards, next_obs, dones):
        """A batch of transitions from numpy arrays (or tensors)."""
        replay_add_batch(self.state, *(torch.as_tensor(np.asarray(x)) for x in
                                       (obs, actions, rewards, next_obs, dones)))

    def sample(self, generator: torch.Generator, batch_size: int) -> Dict[str, torch.Tensor]:
        return replay_sample(self.state, draw_indices(self.state, batch_size, generator))

    def __len__(self) -> int:
        return self.state.host_size


def _sample_indices(rng: np.random.Generator, key, size: int, batch_size: int) -> np.ndarray:
    """Uniform sample indices for host buffers: from ``key`` when given (a
    host integer seed, or the words of a JAX key as an integer array, as the
    JAX package seeds numpy from them), else from the buffer's own
    generator."""
    if key is None:
        return rng.integers(0, max(size, 1), batch_size)
    if isinstance(key, (int, np.integer)):
        rng = np.random.default_rng(int(key))
    else:
        rng = np.random.default_rng(np.asarray(key).astype(np.uint64).ravel())
    return rng.integers(0, max(size, 1), batch_size)


class HostReplayBuffer:
    """NumPy ring buffer for capacities beyond the card's memory; ``sample``
    returns tensors on ``device`` (None: CUDA)."""

    def __init__(
        self,
        capacity: int,
        obs_shape: Tuple[int, ...],
        action_dim: int,
        obs_dtype=np.float32,
        device=None,
    ):
        self.capacity = capacity
        self.device = resolve_device(device)
        self.observations = np.zeros((capacity,) + tuple(obs_shape), obs_dtype)
        self.next_observations = np.zeros((capacity,) + tuple(obs_shape), obs_dtype)
        self.actions = np.zeros((capacity, action_dim), np.float32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), bool)
        self.pos = 0
        self.size = 0
        # For key=None only; seeded from OS entropy so that two buffers do not
        # replay the same indices. Deterministic samples come from a key.
        self._rng = np.random.default_rng()

    def add(self, obs, action, reward, next_obs, done):
        self.add_batch(
            np.asarray(obs)[None], np.asarray(action)[None],
            np.asarray([reward]), np.asarray(next_obs)[None], np.asarray([done]),
        )

    def add_batch(self, obs, actions, rewards, next_obs, dones):
        n = len(obs)
        idx = (self.pos + np.arange(n)) % self.capacity
        self.observations[idx] = obs
        self.next_observations[idx] = next_obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.dones[idx] = dones
        self.pos = int((self.pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def sample(self, key, batch_size: int) -> Dict[str, torch.Tensor]:
        indices = _sample_indices(self._rng, key, self.size, batch_size)
        obs = self.observations[indices]
        next_obs = self.next_observations[indices]
        if obs.dtype == np.uint8:
            obs = obs.astype(np.float32) / 255.0
            next_obs = next_obs.astype(np.float32) / 255.0
        arrays = {
            "observations": obs,
            "actions": self.actions[indices],
            "rewards": self.rewards[indices],
            "next_observations": next_obs,
            "dones": self.dones[indices],
        }
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in arrays.items()}

    def __len__(self) -> int:
        return self.size


class CompressedReplayBuffer:
    """Pixel replay with per-item compressed storage: needs the port's copy
    of the native LZ4 codec, which comes with the pixel slice."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "CompressedReplayBuffer is not ported yet: it comes with the pixel slice and its "
            "copy of native/codec.cpp (ROADMAP A11)"
        )
