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

import flax.linen as fnn
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
from active_inference_diffusion_torch.agents.state_agent import (
    MINE_SAMPLES,
    DiffusionStateAgent,
    TrainDraws,
)
from active_inference_diffusion_torch.bridge import load_jax_params
from active_inference_diffusion_torch.core.active_inference import (
    DiffusionActiveInference as TorchCore,
)
from active_inference_diffusion_torch.core.active_inference import EfeDraws, ElboDraws
from active_inference_diffusion_torch.core.epistemic import EstimatorMasks, MineDraws

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
    cfg = ActiveInferenceConfig(**{
        "observation_dim": OBS_DIM, "action_dim": ACT_DIM, "latent_dim": D, "hidden_dim": H,
        "score_num_layers": L,
        "diffusion": DiffusionConfig(num_diffusion_steps=K, beta_schedule="cosine"),
        **overrides,
    })
    cfg.tpu.donate_buffers = False
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


def train_config() -> ActiveInferenceConfig:
    """The flagship's training flags at the tiny widths: kl_weight 0.5,
    every other flag at its default; deterministic beliefs for exact
    parity."""
    return tiny_config(deterministic_beliefs=True, kl_weight=0.5)


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


# Base values of the synthesised training parameters, by leaf name; every
# other leaf is 0 before the seeded noise.
_BASE = {"scale": 1.0, "freq_scale": 1.0, "time_scale": 1.0, "log_snr_min": -10.0,
         "log_snr_max": 10.0, "perturbation_scale": 0.1}


def jax_train_state(cfg, seed: int = 0):
    """A JAX ``AgentTrainState`` of the agent of ``cfg`` at step 0, built
    without compiling its initialisers: the tree's shapes come from
    ``jax.eval_shape`` of ``init_train_state``, every parameter is its
    ``_BASE`` value plus the noise of ``perturbed``, the optimizers start
    from ``optax`` init, and the time importance, reward normaliser and
    preference temperature are moved off their defaults so the parity
    tests exercise them. Built once per (config, seed)."""
    from active_inference_diffusion_tpu.agents.base import AgentTrainState, subset

    agent = jax_agent(cfg)

    def build():
        shapes = jax.eval_shape(agent.init_train_state, jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)

        def leaf(path, s):
            scale = 0.5 / np.sqrt(s.shape[-2]) if len(s.shape) >= 2 else 0.2
            base = _BASE.get(getattr(path[-1], "key", None), 0.0)
            return np.asarray(base + scale * rng.standard_normal(s.shape), np.float32)

        params = jax.tree_util.tree_map_with_path(leaf, shapes.params)
        # optax's initial states are all zeros (counts and moments)
        opt_states = {
            name: jax.tree_util.tree_map(
                lambda s: np.zeros(s.shape, s.dtype),
                jax.eval_shape(agent.optimizers[name].init,
                               subset(params, agent.PARTITIONS[name])),
            )
            for name in agent.optimizers
        }
        return AgentTrainState(
            step=jnp.zeros((), jnp.int32), params=params, opt_states=opt_states,
            ema_score=params["score"], target_value=params["value"],
            return_scale=jnp.ones((), jnp.float32),
            log_alpha=jnp.log(jnp.float32(cfg.imagined_entropy_scale)),
            time_importance=jnp.asarray(1.0 + 0.5 * rng.standard_normal(100), jnp.float32),
            epistemic_running_mean=jnp.zeros((), jnp.float32),
            reward_norm=type(shapes.reward_norm)(
                mean=jnp.float32(0.3), var=jnp.float32(2.0), count=jnp.float32(50.0)
            ),
            preference_temperature=jnp.float32(1.3),
            rng=jax.random.PRNGKey(seed + 1),
        )

    return _cached(("train_state", _config_key(cfg), seed), build)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


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


# -- the draws of the JAX train step, rebuilt from its keys ----------------


def dropout_masks(module, variables, rng, *args, **kwargs):
    """The keep-masks of every ``nn.Dropout`` call of one training apply of
    ``module`` with dropout key ``rng``, in call order. Masks depend on the
    key and the module path only, so the inputs may be anything of the
    right shape; each dropout is fed ones and its nonzero outputs are the
    kept units."""
    masks = []

    def record(next_fun, fargs, fkwargs, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(fargs[0]), *fargs[1:], **fkwargs)
            masks.append(out != 0)
            return out
        return next_fun(*fargs, **fkwargs)

    with fnn.intercept_methods(record):
        module.apply(variables, *args, rngs={"dropout": rng}, **kwargs)
    return masks


def elbo_draws(jcore, params, elbo_key, time_importance, batch):
    """``elbo_terms``' draws from its key: split in 5 (time, noise, prior,
    decoder dropout, score dropout); the time key in 2 (bins, jitter)."""
    t_key, noise_key, prior_key, drop1, drop2 = jax.random.split(elbo_key, 5)
    cat_key, jitter_key = jax.random.split(t_key)
    z = jnp.zeros((batch, D))
    decoder_masks = dropout_masks(
        jcore.observation_decoder, {"params": params["decoder"]}, drop1, z, train=True
    )
    (score_mask,) = dropout_masks(
        jcore.score_network, {"params": params["score"]}, drop2, z, jnp.full((batch,), 0.5),
        jnp.zeros((batch, OBS_DIM)), continuous=True, train=True,
    )
    return dict(
        decoder_masks=tuple(decoder_masks), score_mask=score_mask,
        time_bins=jax.random.categorical(cat_key, time_importance, shape=(batch,)),
        time_jitter=jax.random.uniform(jitter_key, (batch,), dtype=jnp.float32),
        noise=jax.random.normal(noise_key, (batch, D)),
        prior_noise=jax.random.normal(prior_key, (batch, D)),
    )


def efe_draws(cfg, efe_key, batch):
    """The EFE's draws: its key split per horizon step, each step's key in 3
    (policy, dynamics, epistemic); the dynamics key draws the transition
    noise."""
    n = cfg.num_efe_trajectories * batch

    def step(key):
        pol_key, dyn_key, _ = jax.random.split(key, 3)
        return jax.random.normal(pol_key, (n, ACT_DIM)), jax.random.normal(dyn_key, (n, D))

    pol, dyn = jax.vmap(step)(jax.random.split(efe_key, cfg.efe_horizon))
    return dict(policy_noise=pol, dynamics_noise=dyn)


def mine_draws(jcore, params, epi_key, batch, num_samples=MINE_SAMPLES):
    """``estimate_epistemic_value``'s draws: its key split in 4 (samples,
    probe directions, permutations, dropout)."""
    sample_key, probe_key, perm_key, dropout_key = jax.random.split(epi_key, 4)
    ntk = jcore.epistemic_estimator.ntk_samples
    n = num_samples * batch
    masks = dropout_masks(
        jcore.epistemic_estimator, params["epistemic"], dropout_key,
        jnp.zeros((ntk, n, OBS_DIM)), jnp.zeros((n, D)), jnp.arange(n), train=True,
    )
    return dict(
        noise=jax.random.normal(sample_key, (num_samples, batch, D)),
        directions=jax.random.normal(probe_key, (ntk, n, D)),
        perms=jax.vmap(lambda k: jax.random.permutation(k, batch))(
            jax.random.split(perm_key, num_samples)
        ),
        masks=tuple(masks),
    )


def to_torch(tree):
    return jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.array(x, dtype=np.int64 if x.dtype == jnp.int32 else None)),
        tree,
    )


def draws_from_jax(jagent, state, batch):
    """Every draw of the JAX agent's ``train_step`` from ``state``: its key
    split in 7 (next, belief, elbo, policy, value, epistemic, encoder); the
    belief key's first half draws the sweep's start. One compiled program
    per agent and batch, which always draws the MINE update's too."""
    cfg, core = jagent.config, jagent.core

    def build():
        @fast_jit
        def draw(rng, params, time_importance):
            _, belief_key, elbo_key, policy_key, _, epi_key, _ = jax.random.split(rng, 7)
            init_key, _ = jax.random.split(belief_key)
            return dict(
                belief=jax.random.normal(init_key, (2 * batch, D)),
                elbo=elbo_draws(core, params, elbo_key, time_importance, batch),
                efe=efe_draws(cfg, policy_key, batch),
                mine=mine_draws(core, params, epi_key, batch),
            )

        return draw

    draw = _cached(("draws", _config_key(cfg), batch), build)
    d = to_torch(draw(state.rng, state.params, state.time_importance))
    mine = None
    if int(state.step) % cfg.epistemic_update_every == 0:
        mine = MineDraws(d["mine"]["noise"], d["mine"]["directions"], d["mine"]["perms"],
                         EstimatorMasks(*d["mine"]["masks"]))
    return TrainDraws(d["belief"], torch.tensor(0, dtype=torch.int64), ElboDraws(**d["elbo"]),
                      EfeDraws(**d["efe"]), mine)


# XLA:CPU compiles the tests' JAX programs at optimisation level 0: the same
# programs in about 70% of the compile time; only the order of some float32
# sums may differ. The executables still go to JAX's persistent cache
# (tests/conftest.py), so a later run loads them in about a second; adding
# ``xla_llvm_disable_expensive_passes`` saves a little more on a cold cache
# but keeps them out of it.
_FAST_COMPILE = {"xla_backend_optimization_level": 0}


def fast_jit(fn):
    """``jax.jit(fn)`` compiled at its first call's shapes with
    ``_FAST_COMPILE``; later calls must have the same shapes."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(compiler_options=_FAST_COMPILE))
        return compiled[0](*args)

    return call


def jax_train_step(jagent, state, batch):
    """The JAX agent's ``train_step`` (``_train_step_impl`` under
    ``fast_jit``), compiled once per agent."""
    step = _cached(("train_step", _config_key(jagent.config)),
                   lambda: fast_jit(jagent._train_step_impl))
    return step(state, batch)
