"""Port parity: schedules and the discrete diffusion steps against the JAX
package, same inputs, rtol 1e-6 (the same float32 elementwise arithmetic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.core import diffusion as jdiff
from active_inference_diffusion_tpu.core import schedules as jsched
from active_inference_diffusion_tpu.ops.denoise import (
    sweep_coefficients as jax_sweep_coefficients,
)
from active_inference_diffusion_torch.core import diffusion as tdiff
from active_inference_diffusion_torch.core import schedules as tsched
from active_inference_diffusion_torch.ops.denoise import sweep_coefficients
from torch_parity import normal, t

RTOL = 1e-6


@pytest.mark.parametrize("kind,steps", [("cosine", 25), ("cosine", 100), ("linear", 50)])
def test_schedule_matches_jax(kind, steps):
    ref = jsched.make_schedule(steps, kind)
    ours = tsched.make_schedule(steps, kind)
    assert ours.num_steps == steps
    for name, value in ref._asdict().items():
        got = getattr(ours, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(value), rtol=RTOL, err_msg=name)


def test_extract_q_sample_posterior_mean_match_jax():
    ref = jsched.make_schedule(25, "cosine")
    ours = tsched.make_schedule(25, "cosine")
    z0, zt, noise = normal(0, 16, 6), normal(1, 16, 6), normal(2, 16, 6)
    steps = np.random.default_rng(3).integers(0, 25, size=16)
    tt = torch.from_numpy(steps)
    np.testing.assert_allclose(
        tsched.extract(ours.betas, tt, 2).numpy(),
        np.asarray(jsched.extract(ref.betas, jnp.asarray(steps), 2)), rtol=RTOL,
    )
    np.testing.assert_allclose(
        tdiff.q_sample(ours, t(z0), tt, t(noise)).numpy(),
        np.asarray(jdiff.q_sample(ref, z0, jnp.asarray(steps), noise)), rtol=RTOL,
    )
    np.testing.assert_allclose(
        tdiff.posterior_mean(ours, t(z0), t(zt), tt).numpy(),
        np.asarray(jdiff.posterior_mean(ref, z0, zt, jnp.asarray(steps))), rtol=RTOL,
    )


@pytest.mark.parametrize("deterministic", [True, False])
def test_p_sample_matches_jax(deterministic):
    ref = jsched.make_schedule(25, "cosine")
    ours = tsched.make_schedule(25, "cosine")
    zt, score, noise = normal(0, 16, 6), normal(1, 16, 6), normal(2, 16, 6)
    steps = np.arange(16) % 25  # includes t = 0 (no noise there)
    expected = jdiff.p_sample(ref, zt, jnp.asarray(steps), score, noise, deterministic)
    got = tdiff.p_sample(
        ours, t(zt), torch.from_numpy(steps), t(score), t(noise), deterministic
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=RTOL)


@pytest.mark.parametrize("num_steps,deterministic", [(25, False), (25, True), (10, False)])
def test_sweep_coefficients_match_jax(num_steps, deterministic):
    ref = jax_sweep_coefficients(jsched.make_schedule(25, "cosine"), num_steps, deterministic)
    got = sweep_coefficients(tsched.make_schedule(25, "cosine"), num_steps, deterministic)
    assert got.shape == (num_steps, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    assert float(got[-1, 5]) == 0.0  # no noise at t = 0
