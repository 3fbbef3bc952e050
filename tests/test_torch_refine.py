"""Port parity: the act path's Fokker-Planck belief refinement.

``StateDecoder`` against the Flax module, ``fp_refine_mean`` against the JAX
function with the same numpy noise (and with ``diffusion_coefficient=0``,
which makes the noise term exactly zero), and ``refine_beliefs`` end to end
against the JAX core's, at ``MODEL_TOL`` (float32 both sides; only the
summation order differs). The JAX refinement's noise is recomputed from its
key path: ``fp_refine_mean`` splits the key into one key per step and draws
``jax.random.normal(step_key, z.shape)``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.configs.config import BeliefDynamicsConfig
from active_inference_diffusion_tpu.core import belief_dynamics as jbd
from active_inference_diffusion_torch.core import belief_dynamics as tbd
from torch_parity import (
    MODEL_TOL,
    OBS_DIM,
    B,
    D,
    jax_core_and_params,
    normal,
    t,
    tiny_config,
    torch_core,
)

REFINE = BeliefDynamicsConfig(use_belief_dynamics=True, refine_steps=2)


@pytest.fixture(scope="module")
def cores():
    cfg = tiny_config(belief_dynamics=REFINE)
    jcore, params = jax_core_and_params(cfg)
    return jcore, params, torch_core(cfg, params)


def jax_refine_noise(key, steps, batch):
    return np.stack([
        np.asarray(jax.random.normal(k, (batch, D), jnp.float32))
        for k in jax.random.split(key, steps)
    ])


def close(got, expected):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected), **MODEL_TOL)


def test_state_decoder_matches_flax(cores):
    """The decoder on unit-variance latents, and each of its LayerNorms on
    inputs of variance ~1e-6, where eps 1e-6 (Flax) and 1e-5 (torch's
    default) differ. The torch module is left in training mode: dropout
    follows ``train``, which the act path never sets."""
    from flax import linen as fnn

    jcore, params, tcore = cores
    z = normal(30, B, D)
    expected = jcore.observation_decoder.apply({"params": params["decoder"]}, z, train=False)
    decoder = tcore.observation_decoder.train()
    close(decoder(t(z)), expected)
    close(tcore.decode_observation(t(z)), expected)
    for i in range(3):
        ln = getattr(decoder, f"b{i}_ln")
        x = 1e-3 * normal(31 + i, B, ln.normalized_shape[0])
        close(ln(t(x)), fnn.LayerNorm().apply({"params": params["decoder"][f"b{i}_ln"]}, x))
    with pytest.raises(ValueError, match="dropout masks"):
        decoder(t(z), train=True)


def test_fp_refine_mean_matches_jax():
    """A free energy with a per-element curvature and a sine, three steps:
    without noise (diffusion_coefficient 0), and with the JAX noise handed
    in."""
    a = normal(31, B, D)
    z = 3.0 * normal(32, B, D)
    key = jax.random.PRNGKey(33)

    def jax_fe(zz):
        return 0.5 * jnp.sum(a * zz**2, axis=-1) + jnp.sum(jnp.sin(zz), axis=-1)

    def torch_fe(zz):
        return 0.5 * torch.sum(t(a) * zz**2, dim=-1) + torch.sum(torch.sin(zz), dim=-1)

    for diff in (0.0, 0.5):
        cfg = jbd.FPConfig(diffusion_coefficient=diff, learning_rate=0.3, dt=0.1, noise_scale=0.5)
        expected = jbd.fp_refine_mean(z, key, cfg, jax_fe, num_steps=3)
        tcfg = tbd.FPConfig(**cfg._asdict())
        # diffusion 0: any noise is multiplied by exactly zero
        noise = jax_refine_noise(key, 3, B) if diff else normal(34, 3, B, D)
        got = tbd.fp_refine_mean(t(z), tcfg, torch_fe, num_steps=3, noise=t(noise))
        close(got, expected)
    # the generator path draws (steps, B, D) normals in one call
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    drawn = tbd.fp_refine_mean(t(z), tcfg, torch_fe, 3, generator=g1)
    handed = tbd.fp_refine_mean(t(z), tcfg, torch_fe, 3, noise=torch.randn((3, B, D), generator=g2))
    assert torch.equal(drawn, handed)


@pytest.mark.parametrize("diffusion_coefficient", [0.0, 0.1], ids=["no-noise", "noise"])
def test_refine_beliefs_matches_jax(diffusion_coefficient):
    """The decoder-likelihood free energy of ``refine_beliefs``, two steps,
    under ``no_grad`` as on the act path; the parameters get no ``.grad``."""
    cfg = tiny_config(
        belief_dynamics=dataclasses.replace(REFINE, diffusion_coefficient=diffusion_coefficient)
    )
    jcore, params = jax_core_and_params(cfg)
    tcore = torch_core(cfg, params)
    latent, obs = normal(35, B, D), normal(36, B, OBS_DIM)
    key = jax.random.PRNGKey(37)
    expected = jcore.refine_beliefs(params, key, latent, obs)
    with torch.no_grad():
        got = tcore.refine_beliefs(t(latent), t(obs), noise=t(jax_refine_noise(key, 2, B)))
    close(got, expected)
    assert not got.requires_grad
    assert all(p.grad is None for p in tcore.parameters())
    assert not np.allclose(got.numpy(), latent, atol=1e-3)  # it moved
