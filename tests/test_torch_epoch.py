"""Port parity: ``train_epoch``'s chunks and the mean of its metrics.

The JAX agent's ``train_epoch`` with its compiled chunk (``_train_epoch``)
replaced by a recorder, so nothing compiles: the chunk sizes it asks for
against the port's ``epoch_chunks``, and the mean it returns against the
port's ``train_epoch`` over the same per-update metrics (the port's draws
and update replaced by a counter). The whole update is held against JAX in
tests/test_torch_train.py (three chained ``train_epoch`` calls).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.configs.config import TrainingConfig
from active_inference_diffusion_torch.agents.base import epoch_chunks
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.data.replay import DeviceReplayBuffer
from torch_parity import ACT_DIM, CPU, OBS_DIM, jax_agent, port_config, tiny_config


def metric(i: int) -> float:
    """The recorders' metric of update ``i``: not linear in i, so that a
    mean of chunk means weighted otherwise would differ."""
    return float(np.float32((i % 7) ** 2 + 0.25 * i))


def jax_epoch(monkeypatch, num_updates: int, chunk: int):
    """The JAX agent's ``train_epoch`` with a recorder in place of its
    compiled chunk: returns the chunk sizes it ran and its mean metric."""
    agent = jax_agent(tiny_config())
    monkeypatch.setattr(agent.training_config, "epoch_chunk_updates", chunk)
    sizes = []

    def recorder(state, replay_state, key, n):
        first = sum(sizes)
        sizes.append(n)
        return state, {"m": jnp.mean(jnp.asarray([metric(first + i) for i in range(n)],
                                                 jnp.float32))}

    monkeypatch.setattr(agent, "_train_epoch", recorder)
    monkeypatch.setattr(agent, "total_steps", 0)
    _, metrics = agent.train_epoch(None, None, jax.random.PRNGKey(0), num_updates)
    assert agent.total_steps == num_updates
    return sizes, float(metrics["m"])


@pytest.mark.parametrize("num_updates", [1, 255, 256, 257, 300, 512, 2048])
def test_chunk_sizes_match_jax_agent(monkeypatch, num_updates):
    """JAX's rule at the default ``epoch_chunk_updates`` (256): near-equal
    chunks of at most 256, the larger ones first (257 -> 129, 128)."""
    sizes, _ = jax_epoch(monkeypatch, num_updates, 256)
    assert epoch_chunks(num_updates, 256) == sizes
    assert sum(sizes) == num_updates and max(sizes) <= 256


def test_epoch_metrics_are_the_update_weighted_mean(monkeypatch):
    """300 updates in chunks of at most 128 (three chunks of 100 by JAX's
    rule) and 301 in chunks of 256 (151, 150): the port's ``train_epoch``
    returns the same mean as the JAX agent's over the same per-update
    metrics, 0-d tensors; its step and ``total_steps`` advance by the
    updates; no chunk means none (one chunk)."""
    agent = DiffusionStateAgent(OBS_DIM, ACT_DIM, port_config(tiny_config()),
                                port_config(TrainingConfig()), device=CPU)
    ring = DeviceReplayBuffer(4, (OBS_DIM,), ACT_DIM, device=CPU)

    def update(state, batch, draws):
        value = torch.tensor(metric(state.step))
        state.step += 1
        return state, {"m": value, "twice": 2 * value}

    monkeypatch.setattr(agent, "draw_update",
                        lambda state, replay, b: (torch.zeros(b, dtype=torch.int64), None))
    monkeypatch.setattr(agent, "train_step_from_draws", update)
    for num_updates, chunk in ((300, 128), (301, 256), (5, 0)):
        agent.training_config.epoch_chunk_updates = chunk
        state, agent.total_steps = agent.new_train_state(0), 0
        state, metrics = agent.train_epoch(state, ring.state, num_updates)
        _, want = jax_epoch(monkeypatch, num_updates, chunk)
        assert state.step == agent.total_steps == num_updates
        assert metrics["m"].dim() == 0
        np.testing.assert_allclose(float(metrics["m"]), want, rtol=1e-6)
        np.testing.assert_allclose(float(metrics["twice"]), 2 * want, rtol=1e-6)
