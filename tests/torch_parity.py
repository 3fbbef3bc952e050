"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed, and the same
weights: the JAX modules' initial ``score``, ``policy`` and ``decoder``
parameters perturbed with seeded noise (so the zero-initialised adaLN
modulations and score head do not hide errors), then bridged into the port.
Sizes follow tests/test_pallas_denoise.py.

The JAX side is expensive to set up (tracing and compiling), so the JAX
core, its parameters and the JAX agents are built once per process for each
(config, seed) and shared by every test file (``jax_core_and_params``,
``jax_agent``). The port runs on the CPU, asked for explicitly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from active_inference_diffusion_tpu.agents.state_agent import (
    DiffusionStateAgent as JaxStateAgent,
)
from active_inference_diffusion_tpu.configs.config import (
    ActiveInferenceConfig,
    DiffusionConfig,
    TrainingConfig,
    config_to_dict,
)
from active_inference_diffusion_tpu.core.active_inference import (
    DiffusionActiveInference as JaxCore,
)
from active_inference_diffusion_torch import configs as port_configs
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.bridge import load_jax_params
from active_inference_diffusion_torch.core.active_inference import (
    DiffusionActiveInference as TorchCore,
)

# The tier-1 run puts several test workers on one host, each beside XLA's own
# thread pool; at these sizes two intra-op threads lose nothing.
torch.set_num_threads(2)

B, D, H, K, L = 8, 8, 32, 5, 2
OBS_DIM, ACT_DIM = 5, 2
CPU = torch.device("cpu")

# f32 modules that differ only in summation order (JAX matmuls run at
# "highest" precision, tests/conftest.py).
MODEL_TOL = dict(rtol=2e-4, atol=2e-5)
# bfloat16 sweeps of the two packages: the same rounding sites (every matmul
# operand rounded to bfloat16, float32 sums), but the float32 sums are taken
# in another order, so now and then a value lands on the other side of a
# bfloat16 rounding boundary and the difference (one bfloat16 ulp, 2**-8
# relative) then carries through the later steps. Tighter than the JAX
# package's own bf16-vs-f32 tolerance (rtol 0.1 / atol 0.05), which measures
# the rounding itself.
BF16_TOL = dict(rtol=1e-2, atol=5e-3)

_CACHE: dict = {}


def _config_key(cfg) -> str:
    return json.dumps(config_to_dict(cfg), sort_keys=True, default=str)


def _cached(key, build):
    if key not in _CACHE:
        _CACHE[key] = build()
    return _CACHE[key]


def tiny_config(**overrides) -> ActiveInferenceConfig:
    """A JAX config at the tiny widths; ``port_config`` gives the port's copy."""
    tpu = {k: overrides.pop(k) for k in ("compute_dtype", "denoiser_kernel") if k in overrides}
    cfg = ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=ACT_DIM, latent_dim=D, hidden_dim=H,
        score_num_layers=L,
        diffusion=DiffusionConfig(num_diffusion_steps=K, beta_schedule="cosine"),
        **overrides,
    )
    cfg.tpu.donate_buffers = False
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


def port_config(cfg):
    """The port's config of the same class, fields and values as a JAX one."""
    cls = getattr(port_configs, type(cfg).__name__)
    return port_configs.config._update_dataclass(cls(), config_to_dict(cfg))


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
    """The JAX core of ``cfg`` and perturbed acting groups, initialised as
    ``init_params`` initialises them (``score``, ``policy``, ``decoder``),
    in one compiled init. The parameters depend only on the widths and the
    seed, and are built once for each."""
    cfg = cfg or tiny_config()
    core = _cached(
        ("core", _config_key(cfg)), lambda: JaxCore(OBS_DIM, ACT_DIM, cfg.latent_dim, cfg)
    )
    widths = (cfg.latent_dim, cfg.hidden_dim, cfg.score_num_layers)

    def build():
        z = jnp.zeros((1, cfg.latent_dim))

        @jax.jit
        def init(key):
            keys = jax.random.split(key, 9)
            return {
                "score": core.score_network.init(
                    keys[0], z, jnp.zeros((1,)), jnp.zeros((1, OBS_DIM)),
                    continuous=True, train=False,
                )["params"],
                "policy": core.policy_network.init(keys[1], z)["params"],
                "decoder": core.observation_decoder.init(keys[4], z, train=False)["params"],
            }

        return perturbed(init(jax.random.PRNGKey(seed)), seed)

    return core, _cached(("params", widths, seed), build)


def jax_agent(cfg, training_config=None) -> JaxStateAgent:
    """A JAX state agent for ``cfg``, built once per config: its jitted act
    functions compile once for all the tests that use it."""
    training_config = training_config or TrainingConfig()
    return _cached(
        ("agent", _config_key(cfg), _config_key(training_config)),
        lambda: JaxStateAgent(OBS_DIM, ACT_DIM, cfg, training_config),
    )


def torch_core(cfg, params) -> TorchCore:
    core = TorchCore(OBS_DIM, ACT_DIM, cfg.latent_dim, port_config(cfg), device=CPU)
    load_jax_params(core, params)
    return core


def torch_agent(cfg, params, training_config=None) -> DiffusionStateAgent:
    agent = DiffusionStateAgent(
        OBS_DIM, ACT_DIM, port_config(cfg), port_config(training_config or TrainingConfig()),
        device=CPU,
    )
    agent.load_jax_params(params)
    return agent


def normal(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32).copy())
