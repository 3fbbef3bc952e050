"""Port parity: the replay buffers (``data/replay.py``).

The device ring against the JAX package's ``replay_init`` /
``replay_add_batch`` / ``replay_sample`` on the same transitions, with the
indices of JAX's ``jax.random.randint`` handed to the port's gather: every
field exactly, float32 and uint8 observations (decoded to [0, 1]), through a
wrap-around. The host ring and ``_sample_indices`` against the JAX package's
bit for bit. The port's own index draw: in range and uniform. Both sides on
the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.data import replay as jreplay
from active_inference_diffusion_torch.data import replay as treplay
from torch_parity import ACT_DIM, CPU, OBS_DIM

CAPACITY, BATCHES = 7, (3, 5, 4)  # the second batch wraps, the third wraps again


def transitions(n, seed, uint8):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (n, OBS_DIM)) if uint8 else rng.standard_normal((n, OBS_DIM))
    next_obs = rng.integers(0, 256, (n, OBS_DIM)) if uint8 else rng.standard_normal((n, OBS_DIM))
    dtype = np.uint8 if uint8 else np.float32
    return (obs.astype(dtype), rng.standard_normal((n, ACT_DIM)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32), next_obs.astype(dtype), rng.random(n) < 0.3)


def assert_same(port: dict, jax_side: dict):
    assert set(port) == set(jax_side)
    for name, value in jax_side.items():
        got = port[name].numpy()
        assert got.dtype == np.asarray(value).dtype, name
        np.testing.assert_array_equal(got, np.asarray(value), err_msg=name)


@pytest.mark.parametrize("uint8", [False, True], ids=["float32", "uint8"])
def test_ring_matches_jax_replay(uint8):
    """Three batches into a ring of 7 (wrapping twice): pos, size and every
    stored field after each, then a sample at JAX's indices."""
    jstate = jreplay.replay_init(CAPACITY, (OBS_DIM,), ACT_DIM,
                                 jnp.uint8 if uint8 else jnp.float32)
    buf = treplay.DeviceReplayBuffer(CAPACITY, (OBS_DIM,), ACT_DIM,
                                     torch.uint8 if uint8 else torch.float32, device=CPU)
    for i, n in enumerate(BATCHES):
        batch = transitions(n, i, uint8)
        jstate = jreplay.replay_add_batch(jstate, *(jnp.asarray(x) for x in batch))
        buf.add_batch(*batch)
        st = buf.state
        assert (int(st.pos), int(st.size)) == (st.host_pos, st.host_size) == (
            int(jstate.pos), int(jstate.size))
        assert len(buf) == int(jstate.size)
        for name in ("observations", "actions", "rewards", "next_observations", "dones"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(jstate, name)), err_msg=name)
    key = jax.random.PRNGKey(3)
    indices = jax.random.randint(key, (16,), 0, jnp.maximum(jstate.size, 1))
    port = treplay.replay_sample(buf.state, torch.from_numpy(np.asarray(indices, np.int64)))
    want = jreplay.replay_sample(jstate, key, 16)
    assert_same(port, want)
    assert port["observations"].dtype == torch.float32


def test_host_buffer_and_sample_indices_match_jax():
    """``_sample_indices`` for a host seed and for a key's words gives the
    JAX package's integers; the host ring stores and samples as its
    ``HostReplayBuffer`` does (uint8 decoded)."""
    rng = np.random.default_rng(0)
    for key in (7, np.int64(123456789), np.asarray(jax.random.PRNGKey(5))):
        np.testing.assert_array_equal(treplay._sample_indices(rng, key, 50, 32),
                                      jreplay._sample_indices(rng, key, 50, 32))
    jbuf = jreplay.HostReplayBuffer(CAPACITY, (OBS_DIM,), ACT_DIM, np.uint8)
    tbuf = treplay.HostReplayBuffer(CAPACITY, (OBS_DIM,), ACT_DIM, np.uint8, device=CPU)
    for i, n in enumerate(BATCHES):
        batch = transitions(n, 10 + i, True)
        jbuf.add_batch(*batch)
        tbuf.add_batch(*batch)
    tbuf.add(*(x[0] for x in transitions(1, 20, True)))
    jbuf.add(*(x[0] for x in transitions(1, 20, True)))
    assert (tbuf.pos, tbuf.size, len(tbuf)) == (jbuf.pos, jbuf.size, len(jbuf))
    assert_same(tbuf.sample(11, 9), jbuf.sample(11, 9))


def test_index_draw_is_uniform_in_range():
    """The port's draw from an explicit generator: within [0, size) by the
    host mirror of the fill, each index within 0.01 of uniform over 40,000
    draws, the same integers again from the same seed; an empty ring draws
    0."""
    buf = treplay.DeviceReplayBuffer(16, (OBS_DIM,), ACT_DIM, device=CPU)
    empty = treplay.draw_indices(buf.state, 8, torch.Generator().manual_seed(0))
    assert empty.dtype == torch.int64 and bool((empty == 0).all())
    buf.add_batch(*transitions(10, 1, False))
    draws = treplay.draw_indices(buf.state, 40_000, torch.Generator().manual_seed(0))
    assert int(draws.min()) == 0 and int(draws.max()) == 9
    freq = torch.bincount(draws, minlength=10).double() / draws.numel()
    assert float((freq - 0.1).abs().max()) < 0.01
    again = torch.empty(40_000, dtype=torch.int64)
    treplay.draw_indices(buf.state, 40_000, torch.Generator().manual_seed(0), out=again)
    assert torch.equal(again, draws)
    sample = buf.sample(torch.Generator().manual_seed(0), 40_000)
    np.testing.assert_array_equal(sample["rewards"].numpy(),
                                  buf.state.rewards[draws].numpy())


def test_compressed_buffer_waits_for_the_pixel_slice():
    with pytest.raises(NotImplementedError, match="A11"):
        treplay.CompressedReplayBuffer(8, (3, 8, 8), ACT_DIM)
