"""Shared set-up of the port's parity tests (tests/test_torch_*.py).

Both packages get the same inputs, made with numpy from a seed, and the same
weights: the JAX modules' initial ``score``, ``policy`` and ``decoder``
parameters perturbed with seeded noise (so the zero-initialised adaLN
modulations and score head do not hide errors), then bridged into the port.
Sizes follow tests/test_pallas_denoise.py.

The JAX side is expensive to set up (tracing and compiling), so the JAX
core, its parameters and the JAX agents are built once per process for each
(config, seed) and shared by every test file (``jax_core_and_params``,
``jax_agent``). What the JAX train steps compute (``chained_steps``,
``chained_epochs``) is computed once per test run (``shared``): under
pytest-xdist the cases of one comparison land on several workers, and the
first to need it builds it while the others load its result. The port runs
on the CPU, asked for explicitly.
"""

import atexit
import fcntl
import hashlib
import json
import os
import pickle
import shutil
import tempfile
from pathlib import Path

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
from active_inference_diffusion_torch.bridge import (
    group_arrays,
    load_jax_params,
    train_state_from_jax,
)
from active_inference_diffusion_torch.core.active_inference import (
    DiffusionActiveInference as TorchCore,
)
from active_inference_diffusion_torch.core.active_inference import (
    GROUP_MODULES,
    EfeDraws,
    ElboDraws,
)
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
_RUN: dict = {}  # the run's directory of shared results, once made


def _config_key(cfg) -> str:
    return json.dumps(config_to_dict(cfg), sort_keys=True, default=str)


def _cached(key, build):
    if key not in _CACHE:
        _CACHE[key] = build()
    return _CACHE[key]


def _run_directory():
    """The run's directory of shared results, ``torch_parity_<run id>`` in
    the temporary directory (``PYTEST_XDIST_TESTRUNUID`` names the run);
    None without xdist. A worker that uses it holds a shared lock on its
    ``users`` file until it exits, and the last to exit removes it
    (``_leave``)."""
    if "dir" in _RUN:
        return _RUN["dir"]
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run is None:
        return None
    directory = Path(tempfile.gettempdir()) / f"torch_parity_{run}"
    users_path = directory / "users"
    while True:  # again where the last user removed it meanwhile
        directory.mkdir(exist_ok=True)
        try:
            users = open(users_path, "a")
        except FileNotFoundError:
            continue
        fcntl.flock(users, fcntl.LOCK_SH)
        try:
            if os.path.samestat(os.fstat(users.fileno()), os.stat(users_path)):
                break
        except FileNotFoundError:
            pass
        users.close()
    atexit.register(_leave, directory, users)
    _RUN["dir"] = directory
    return directory


def _leave(directory: Path, users) -> None:
    """At a worker's exit: removes the run's directory unless another
    worker still holds it."""
    try:
        fcntl.flock(users, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:
        pass
    else:
        shutil.rmtree(directory, ignore_errors=True)
    users.close()


def _shared_paths(key):
    """The lock file and the result file of ``key`` in the run's directory;
    None without xdist."""
    directory = _run_directory()
    if directory is None:
        return None
    name = hashlib.sha256(repr(key).encode()).hexdigest()[:40]
    return directory / f"{name}.lock", directory / f"{name}.pkl"


def shared(key, build):
    """``build()``'s result (numpy arrays, torch tensors and plain
    containers), computed once per test run: under pytest-xdist the first
    worker to ask builds it under a lock file and pickles it into the run's
    directory, and the others wait for it and load it; without xdist, once
    per process. ``key``'s repr names it; a build never asks for another
    shared result, so no two workers wait on each other. The run's
    directory goes when its last worker exits (``_run_directory``)."""
    if key in _CACHE:
        return _CACHE[key]
    paths = _shared_paths(key)
    if paths is None:
        return _cached(key, build)
    lock_path, path = paths
    with open(lock_path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            value = pickle.loads(path.read_bytes())
        else:
            value = build()
            partial = path.with_suffix(".partial")  # whole or not at all
            partial.write_bytes(pickle.dumps(value))
            partial.rename(path)
    _CACHE[key] = value
    return value


def digest(tree) -> str:
    """A name for a tree of arrays by its structure and contents."""
    h = hashlib.sha256(str(jax.tree_util.tree_structure(tree)).encode())
    for leaf in jax.tree_util.tree_leaves(tree):
        leaf = np.asarray(leaf)
        h.update(f"{leaf.dtype}{leaf.shape}".encode())
        h.update(leaf.tobytes())
    return h.hexdigest()


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


def ground_config() -> ActiveInferenceConfig:
    """The flagship's training flags at the tiny widths with grounded,
    stochastic beliefs (``ground_beliefs``, the sweep inside the loss)."""
    return tiny_config(ground_beliefs=True, kl_weight=0.5)


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
        ("core", _config_key(cfg)),
        lambda: JaxCore(cfg.observation_dim, cfg.action_dim, cfg.latent_dim, cfg)
    )
    widths = (cfg.latent_dim, cfg.hidden_dim, cfg.score_num_layers, cfg.observation_dim,
              cfg.action_dim)

    def build():
        z = jnp.zeros((1, cfg.latent_dim))

        @jax.jit
        def init(key):
            keys = jax.random.split(key, 9)
            return {
                "score": core.score_network.init(
                    keys[0], z, jnp.zeros((1,)), jnp.zeros((1, cfg.observation_dim)),
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
        lambda: JaxStateAgent(cfg.observation_dim, cfg.action_dim, cfg, training_config),
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
    core = TorchCore(cfg.observation_dim, cfg.action_dim, cfg.latent_dim, port_config(cfg),
                     device=CPU)
    load_jax_params(core, params)
    return core


def torch_agent(cfg, params, training_config=None) -> DiffusionStateAgent:
    agent = DiffusionStateAgent(
        cfg.observation_dim, cfg.action_dim, port_config(cfg),
        port_config(training_config or TrainingConfig()), device=CPU,
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
        jnp.zeros((batch, jcore.observation_dim)), continuous=True, train=True,
    )
    return dict(
        decoder_masks=tuple(decoder_masks), score_mask=score_mask,
        time_bins=jax.random.categorical(cat_key, time_importance, shape=(batch,)),
        time_jitter=jax.random.uniform(jitter_key, (batch,), dtype=jnp.float32),
        noise=jax.random.normal(noise_key, (batch, D)),
        prior_noise=jax.random.normal(prior_key, (batch, D)),
    )


def efe_draws(cfg, efe_key, batch, parts=3):
    """An imagined rollout's draws: its key split per horizon step, each
    step's key in ``parts`` (the EFE's 3: policy, dynamics, epistemic; the
    imagined objective's 2: policy, dynamics); the dynamics key draws the
    transition noise and, with an ensemble, each row's member on
    ``fold_in(dynamics key, 1)`` (``imagine_next``)."""
    n = cfg.num_efe_trajectories * batch
    k = cfg.num_dynamics_ensemble

    def step(key):
        pol_key, dyn_key = jax.random.split(key, parts)[:2]
        out = dict(policy_noise=jax.random.normal(pol_key, (n, cfg.action_dim)),
                   dynamics_noise=jax.random.normal(dyn_key, (n, D)))
        if k > 1:
            out["members"] = jax.random.randint(jax.random.fold_in(dyn_key, 1), (n,), 0, k)
        return out

    return jax.vmap(step)(jax.random.split(efe_key, cfg.efe_horizon))


def mine_draws(jcore, params, epi_key, batch, num_samples=MINE_SAMPLES):
    """``estimate_epistemic_value``'s draws: its key split in 4 (samples,
    probe directions, permutations, dropout)."""
    sample_key, probe_key, perm_key, dropout_key = jax.random.split(epi_key, 4)
    ntk = jcore.epistemic_estimator.ntk_samples
    n = num_samples * batch
    masks = dropout_masks(
        jcore.epistemic_estimator, params["epistemic"], dropout_key,
        jnp.zeros((ntk, n, jcore.observation_dim)), jnp.zeros((n, D)), jnp.arange(n),
        train=True,
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
    belief key's first half draws the sweep's start, or with
    ``posterior_beliefs`` the belief key itself the posterior's eps; with
    stochastic ``ground_beliefs`` its second half split per sweep step
    draws each step's noise (``generate_beliefs``' scan); the policy key
    draws the actor's rollout (the imagined objective's with
    ``imagined_value_targets``). One compiled program per agent and batch,
    which always draws the MINE update's too."""
    cfg, core = jagent.config, jagent.core
    grounded = cfg.ground_beliefs and not cfg.deterministic_beliefs
    k = cfg.diffusion.num_diffusion_steps

    def build():
        @fast_jit
        def draw(rng, params, time_importance):
            _, belief_key, elbo_key, policy_key, _, epi_key, _ = jax.random.split(rng, 7)
            sweep = {}
            if not cfg.posterior_beliefs:
                belief_key, scan_key = jax.random.split(belief_key)
                if grounded:
                    sweep["sweep"] = jax.vmap(lambda key: jax.random.normal(key, (2 * batch, D)))(
                        jax.random.split(scan_key, k))
            return dict(
                **sweep,
                belief=jax.random.normal(belief_key, (2 * batch, D)),
                elbo=elbo_draws(core, params, elbo_key, time_importance, batch),
                efe=efe_draws(cfg, policy_key, batch, 2 if cfg.imagined_value_targets else 3),
                mine=mine_draws(core, params, epi_key, batch),
            )

        return draw

    draw = _cached(("draws", _config_key(cfg), batch), build)
    d = to_torch(draw(state.rng, state.params, state.time_importance))
    mine = None
    if int(np.asarray(state.step)) % cfg.epistemic_update_every == 0:
        mine = MineDraws(d["mine"]["noise"], d["mine"]["directions"], d["mine"]["perms"],
                         EstimatorMasks(*d["mine"]["masks"]))
    return TrainDraws(d["belief"], torch.tensor(0, dtype=torch.int64), ElboDraws(**d["elbo"]),
                      EfeDraws(**d["efe"]), mine, d.get("sweep"))


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


# -- train updates of both packages, held against each other -----------------
#
# The rules (tests/test_torch_train.py's docstring states them in full):
# metrics and state fields at MODEL_TOL; gradients, as Adam's first moments,
# at GRAD_RTOL / GRAD_ATOL times the partition's largest moment; parameters
# at MODEL_TOL plus 2 lr a step where the two gradients' signs differ, with
# fewer than 1 in 100 elements of a partition under that rule.

GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
RING = 16  # the epoch's ring: 20 transitions wrap it


def make_batch(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "observations": normal(seed, B, OBS_DIM),
        "next_observations": normal(seed + 1, B, OBS_DIM),
        "actions": np.tanh(normal(seed + 2, B, ACT_DIM)),
        "rewards": 2.0 * normal(seed + 3, B),
        "dones": (rng.random(B) < 0.25).astype(np.float32),
    }


def port_grads(out, part, step):
    """A partition's port gradients at ``step``, in its optimizer's order:
    the clipped gradients its AdamW took, where it stepped (rebuilding them
    from the moments, as for JAX, would leave a residue of ~1e-10 where the
    gradient is exactly 0: torch's AdamW takes the moment by ``lerp``, not
    as 0.9 mu + 0.1 g), else from the first moments."""
    if part in out[step]["grads"]:
        return out[step]["grads"][part]
    mu = out[step]["mu"][part]
    if step == 0:
        return [m / 0.1 for m in mu]
    return [(m - 0.9 * m0) / 0.1 for m, m0 in zip(mu, out[step - 1]["mu"][part])]


def jax_grads(out, agent, part, step):
    """A partition's JAX gradients at ``step``, by (group, name), from the
    first moments."""
    mu = jax_by_name(agent, adam_mu(out[step]["jstate"].opt_states[part]))
    if step == 0:
        return {k: v / 0.1 for k, v in mu.items()}
    mu0 = jax_by_name(agent, adam_mu(out[step - 1]["jstate"].opt_states[part]))
    return {k: (v - 0.9 * mu0[k]) / 0.1 for k, v in mu.items()}


def adam_mu(opt_state):
    """The first moment of an ``optax.chain(clip, adamw)`` state."""
    for part in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(part, "mu"):
            return part.mu
    raise KeyError("no Adam state")


def named(agent, partition):
    """(group, torch name) of each parameter of a partition, in its
    optimizer's order."""
    return [(g, n) for g in agent.PARTITIONS[partition]
            for n, _ in getattr(agent.core, GROUP_MODULES[g]).named_parameters()]


def jax_by_name(agent, tree):
    """A tree of JAX parameter groups as {(group, torch name): array}."""
    out = {}
    for group, sub in tree.items():
        if group in GROUP_MODULES:
            module = getattr(agent.core, GROUP_MODULES[group])
            out.update({(group, n): a for n, a in group_arrays(module, sub, group).items()})
    return out


def _numpy_dict(tensors):
    return None if tensors is None else {n: v.numpy().copy() for n, v in tensors.items()}


def record(agent, state, metrics, jstate, jmetrics, draws, grads) -> dict:
    """One update of both agents, as numpy; ``grads`` holds what the port's
    optimizers took in it."""
    out = dict(
        jmetrics=numpy_tree(jmetrics), metrics={k: v.numpy() for k, v in metrics.items()},
        jstate=numpy_tree(jstate), mine=draws.mine is not None,
        params={(g, n): p.detach().numpy().copy() for part in agent.PARTITIONS
                for (g, n), p in zip(named(agent, part), state.optimizers[part].params)},
        mu={part: [state.optimizers[part].adamw.state[p]["exp_avg"].numpy().copy()
                   for p in state.optimizers[part].params] for part in agent.PARTITIONS},
        lr={part: opt.adamw.param_groups[0]["lr"] for part, opt in state.optimizers.items()},
        ema=_numpy_dict(state.ema_score), target_value=_numpy_dict(state.target_value),
        ema_policy=_numpy_dict(state.ema_policy),
        time_importance=state.time_importance.numpy().copy(),
        reward_norm=[float(x) for x in (state.reward_norm.mean, state.reward_norm.var,
                                         state.reward_norm.count)],
        scalars=[float(x) for x in (state.epistemic_running_mean, state.return_scale,
                                    state.log_alpha)],
        step=state.step, grads=dict(grads),
    )
    grads.clear()
    return out


def start(cfg, jstate):
    """The port's agent on the JAX state ``jstate`` (numpy), and a dict that
    takes each port optimizer's clipped gradients (partition -> numpy
    arrays) when it steps."""
    agent = DiffusionStateAgent(
        cfg.observation_dim, cfg.action_dim, port_config(cfg), port_config(TrainingConfig()),
        device=CPU,
    )
    state = train_state_from_jax(agent, jstate)
    grads = {}
    for part, opt in state.optimizers.items():
        opt.adamw.register_step_pre_hook(
            lambda adamw, args, kwargs, part=part, params=opt.params: grads.__setitem__(
                part, [q.grad.detach().numpy().copy() for q in params]))
    return agent, state, grads


def jax_side(cfg, jstate=None):
    """What the JAX train step of ``cfg`` computes for the comparisons,
    from ``jstate`` (``jax_train_state`` unless given), once per test run
    (``shared``), so one process traces the program: ``"steps"``, two
    chained ``train_step``s on a batch each (``make_batch``), and
    ``"epoch"``, the JAX ``train_epoch``'s scan body three times over a ring
    of ``epoch_data`` (``replay_sample`` on ``fold_in(k, 0)``, then the
    train step). Each is (the states as numpy, from the first; per update
    its batch or ring indices, its draws and its metrics)."""
    return shared(jax_side_key(cfg, jstate), lambda: build_jax_side(cfg, jstate))


def jax_side_key(cfg, jstate=None):
    return ("train step", _config_key(cfg), "default" if jstate is None else digest(jstate))


def build_jax_side(cfg, jstate=None):
    """``jax_side``'s result, built here."""
    from active_inference_diffusion_tpu.data import replay as jreplay

    jagent = jax_agent(cfg)
    first = jax_train_state(cfg) if jstate is None else jstate
    states, steps = [first], []
    for i in range(2):
        batch = make_batch(10 * i + 3)
        draws = draws_from_jax(jagent, states[-1], B)
        jnext, jmetrics = jax_train_step(jagent, states[-1],
                                         {k: jnp.asarray(v) for k, v in batch.items()})
        states.append(jnext)
        steps.append(dict(batch=batch, draws=draws, jmetrics=numpy_tree(jmetrics)))
    epoch_states, updates = [first], []
    jring = jreplay.replay_add_batch(jreplay.replay_init(RING, (OBS_DIM,), ACT_DIM),
                                     *(jnp.asarray(x) for x in epoch_data()))
    for u in range(3):
        key = jax.random.fold_in(jax.random.PRNGKey(60 + u), 0)
        indices = jax.random.randint(key, (B,), 0, jnp.maximum(jring.size, 1))
        jbatch = jreplay.replay_sample(jring, key, B)
        jbatch["dones"] = jbatch["dones"].astype(jnp.float32)  # the program's input type
        draws = draws_from_jax(jagent, epoch_states[-1], B)
        jnext, jmetrics = jax_train_step(jagent, epoch_states[-1], jbatch)
        epoch_states.append(jnext)
        updates.append(dict(indices=np.asarray(indices, np.int64), draws=draws,
                            jmetrics=numpy_tree(jmetrics)))
    return {"steps": ([numpy_tree(s) for s in states], steps),
            "epoch": ([numpy_tree(s) for s in epoch_states], updates)}


def chained_steps(cfg, jstate=None):
    """Two chained ``train_step``s of both agents from one state, a batch
    each (``make_batch``), the port on the JAX step's draws (``jax_side``).
    Returns (the port's agent, the JAX states as numpy, the records with
    each update's batch and draws)."""
    jstates, steps = jax_side(cfg, jstate)["steps"]
    agent, state, grads = start(cfg, jstates[0])
    out = []
    for i, step in enumerate(steps):
        state, metrics = agent.train_step_from_draws(
            state, {k: t(v) for k, v in step["batch"].items()}, step["draws"]
        )
        out.append(record(agent, state, metrics, jstates[i + 1], step["jmetrics"],
                          step["draws"], grads))
        out[-1].update(batch=step["batch"], draws=step["draws"])
    return agent, jstates, out


def epoch_data():
    """The epoch's transitions: 20, which wrap the ring of ``RING``."""
    rng = np.random.default_rng(7)
    return (normal(70, 20, OBS_DIM), np.tanh(normal(71, 20, ACT_DIM)), 2.0 * normal(72, 20),
            normal(73, 20, OBS_DIM), rng.random(20) < 0.25)


def chained_epochs(cfg, jstate=None):
    """Three chained calls of the port's ``train_epoch`` of one update each,
    over a device ring on the CPU, against the JAX ``train_epoch``'s scan
    body (``jax_side``): the port's ring indices are JAX's ``randint`` draw,
    its update's draws ``draws_from_jax``."""
    from active_inference_diffusion_torch.data.replay import DeviceReplayBuffer

    jstates, updates = jax_side(cfg, jstate)["epoch"]
    agent, state, grads = start(cfg, jstates[0])
    ring = DeviceReplayBuffer(RING, (OBS_DIM,), ACT_DIM, device=CPU)
    ring.add_batch(*epoch_data())
    pending = []
    agent.draw_update = lambda state, replay_state, batch_size: pending.pop(0)
    out = []
    for u, update in enumerate(updates):
        pending.append((torch.from_numpy(update["indices"]), update["draws"]))
        state, metrics = agent.train_epoch(state, ring.state, 1)
        assert not pending and agent.total_steps == u + 1
        out.append(record(agent, state, metrics, jstates[u + 1], update["jmetrics"],
                          update["draws"], grads))
    return agent, jstates, out


def _close_dicts(got, module, jtree, group):
    want = group_arrays(module, jtree, group)
    assert set(got) == set(want), group
    for name, value in got.items():
        np.testing.assert_allclose(value, want[name], err_msg=f"{group} EMA {name}", **MODEL_TOL)


def check_update(agent, jstates, out, step):
    """Update ``step`` of ``out`` against the JAX agent's, by the rules
    above: every metric, the state's fields (time importance, reward
    normaliser, MINE running mean, return scale, log_alpha, the score EMA,
    the slow critic, the EMA policy), and every partition's gradients and
    parameters."""
    got = out[step]
    jstate = got["jstate"]
    assert got["mine"] == (step == 0) and got["step"] == step + 1
    assert set(got["metrics"]) == set(got["jmetrics"])
    for name, value in got["jmetrics"].items():
        np.testing.assert_allclose(got["metrics"][name], value, err_msg=name, **MODEL_TOL)
    assert (got["metrics"]["epistemic_mi"] != 0) == (step == 0)

    np.testing.assert_allclose(got["time_importance"], jstate.time_importance, **MODEL_TOL)
    norm = jstate.reward_norm
    np.testing.assert_allclose(got["reward_norm"], [norm.mean, norm.var, norm.count], **MODEL_TOL)
    np.testing.assert_allclose(
        got["scalars"], [jstate.epistemic_running_mean, jstate.return_scale, jstate.log_alpha],
        err_msg="MINE running mean, return scale, log_alpha", **MODEL_TOL)
    core = agent.core
    _close_dicts(got["ema"], core.score_network, jstate.ema_score, "score")
    _close_dicts(got["target_value"], core.value_network, jstate.target_value, "value")
    assert (got["ema_policy"] is None) == (jstate.ema_policy is None)
    if jstate.ema_policy is not None:
        _close_dicts(got["ema_policy"], core.policy_network, jstate.ema_policy, "policy")

    jparams = jax_by_name(agent, jstate.params)
    for part in agent.PARTITIONS:
        names = named(agent, part)
        # gradients, as the first moments: 0.1 g after step 0
        jmu = jax_by_name(agent, adam_mu(jstate.opt_states[part]))
        mu_scale = max(float(np.abs(jmu[k]).max()) for k in names)
        for k, m in zip(names, got["mu"][part]):
            np.testing.assert_allclose(m, jmu[k], rtol=GRAD_RTOL, atol=GRAD_ATOL * mu_scale,
                                       err_msg=f"{part} first moment {k}")
            if step == 0:  # a clamp or a dead unit: exactly zero on both sides
                assert (m[jmu[k] == 0] == 0).all(), (part, k)
        # parameters: MODEL_TOL, or 2 lr a step where the sign of g is open
        lr = got["lr"][part]
        jgrads = [jax_grads(out, agent, part, s) for s in range(step + 1)]
        pgrads = [port_grads(out, part, s) for s in range(step + 1)]
        small = total = 0
        for i, k in enumerate(names):
            slack = 2 * lr * sum(
                np.sign(gp[i]) != np.sign(gj[k]) for gj, gp in zip(jgrads, pgrads)
            )
            small += int(np.count_nonzero(slack))
            total += slack.size
            err = np.abs(got["params"][k] - jparams[k])
            bound = MODEL_TOL["atol"] + MODEL_TOL["rtol"] * np.abs(jparams[k]) + slack
            assert (err <= bound).all(), (part, k, float((err - bound).max()))
        print(f"{part}: {small} of {total} elements under the sign rule")
        assert small * 100 < total, (part, small, total)

