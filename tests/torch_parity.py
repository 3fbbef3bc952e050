"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed, and the same
weights: the JAX modules' initial ``score`` and ``policy`` parameters
perturbed with seeded noise (so the zero-initialised adaLN modulations and
score head do not hide errors), then bridged into the port. Sizes follow
tests/test_pallas_denoise.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from active_inference_diffusion_tpu.configs.config import (
    ActiveInferenceConfig,
    DiffusionConfig,
)
from active_inference_diffusion_tpu.core.active_inference import (
    DiffusionActiveInference as JaxCore,
)
from active_inference_diffusion_torch.bridge import load_jax_params
from active_inference_diffusion_torch.core.active_inference import (
    DiffusionActiveInference as TorchCore,
)

B, D, H, K, L = 8, 8, 32, 5, 2
OBS_DIM, ACT_DIM = 5, 2

# f32 modules that differ only in summation order (JAX matmuls run at
# "highest" precision, tests/conftest.py).
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)


def tiny_config(**overrides) -> ActiveInferenceConfig:
    cfg = ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=ACT_DIM, latent_dim=D, hidden_dim=H,
        score_num_layers=L,
        diffusion=DiffusionConfig(num_diffusion_steps=K, beta_schedule="cosine"),
        **overrides,
    )
    cfg.tpu.donate_buffers = False
    return cfg


def perturbed(params, seed: int = 0):
    """Numpy copy of a JAX parameter tree with seeded noise added to every
    leaf (scaled by 1/sqrt(fan_in) for matrices)."""
    rng = np.random.default_rng(seed)

    def noisy(leaf):
        leaf = np.asarray(leaf, np.float32)
        scale = 0.5 / np.sqrt(leaf.shape[0]) if leaf.ndim == 2 else 0.2
        return (leaf + scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map(noisy, params)


def jax_core_and_params(cfg=None, seed: int = 0):
    """The JAX core and its perturbed acting groups, initialised as
    ``init_params`` initialises them (``score``, ``policy``)."""
    cfg = cfg or tiny_config()
    core = JaxCore(OBS_DIM, ACT_DIM, cfg.latent_dim, cfg)
    keys = jax.random.split(jax.random.PRNGKey(seed), 9)
    z = jnp.zeros((1, cfg.latent_dim))
    params = {
        "score": core.score_network.init(
            keys[0], z, jnp.zeros((1,)), jnp.zeros((1, OBS_DIM)),
            continuous=True, train=False,
        )["params"],
        "policy": core.policy_network.init(keys[1], z)["params"],
    }
    return core, perturbed(params, seed)


def torch_core(cfg, params) -> TorchCore:
    core = TorchCore(OBS_DIM, ACT_DIM, cfg.latent_dim, cfg)
    load_jax_params(core, params)
    return core


def normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())
