"""Port parity: the modules of the training slice, one by one.

Both packages get the parameters of ``jax_train_state`` (seeded, off
their initial values), the inputs come from numpy seeds, and every draw is
the JAX one, rebuilt from its key and handed to the port. JAX runs eagerly
at these tiny sizes. float32 on both sides, only the summation order
differs: ``MODEL_TOL`` (rtol 2e-4 / atol 2e-5) throughout, on values and
on gradients. The ELBO terms, the EFE and the MINE estimate are held on the
JAX train step's own inputs, in tests/test_torch_train.py
(``test_step_modules_match_jax``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from active_inference_diffusion_tpu.configs.config import TrainingConfig
from active_inference_diffusion_tpu.core import diffusion as jdiff
from active_inference_diffusion_tpu.core import epistemic as jepi
from active_inference_diffusion_tpu.core import free_energy as jfe
from active_inference_diffusion_tpu.core import returns as jreturns
from active_inference_diffusion_tpu.core import time_sampler as jtime
from active_inference_diffusion_tpu.models import common as jcommon
from active_inference_diffusion_tpu.models.decoders import reward_log_prob as jax_reward_log_prob
from active_inference_diffusion_torch import configs as port_configs
from active_inference_diffusion_torch.agents.base import CosineDecay, PartitionOptimizer
from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
from active_inference_diffusion_torch.bridge import group_arrays, load_flax_group, load_jax_params
from active_inference_diffusion_torch.core import diffusion as tdiff
from active_inference_diffusion_torch.core import epistemic as tepi
from active_inference_diffusion_torch.core import free_energy as tfe
from active_inference_diffusion_torch.core import returns as treturns
from active_inference_diffusion_torch.core import time_sampler as ttime
from active_inference_diffusion_torch.core.active_inference import (
    GROUP_MODULES,
    DiffusionActiveInference as TorchCore,
)
from active_inference_diffusion_torch.models import common as tcommon
from active_inference_diffusion_torch.models.decoders import reward_log_prob
from active_inference_diffusion_torch.models.dynamics import LatentDynamicsModel
from active_inference_diffusion_torch.ops.denoise import kernel_takes
from torch_parity import (
    ACT_DIM,
    CPU,
    MODEL_TOL,
    OBS_DIM,
    B,
    D,
    H,
    dropout_masks,
    fast_jit,
    jax_agent,
    jax_train_state,
    normal,
    numpy_tree,
    port_config,
    t,
    tiny_config,
    train_config,
)


def close(got, expected, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(expected), err_msg=err_msg, **MODEL_TOL)


def grads_close(module, grads, group_name):
    """Gradients of a port module against a JAX gradient tree of its group."""
    expected = group_arrays(module, grads, group_name)
    for name, p in module.named_parameters():
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        close(got, expected[name], err_msg=f"{group_name} gradient {name}")


@pytest.fixture(scope="module")
def setup():
    """The JAX core and parameters of the flagship-flag config, and the port
    core with every ported group loaded."""
    cfg = train_config()
    jagent = jax_agent(cfg)
    params = numpy_tree(jax_train_state(cfg).params)
    agent = DiffusionStateAgent(
        OBS_DIM, ACT_DIM, port_config(cfg), port_config(TrainingConfig()), device=CPU
    )
    load_jax_params(agent.core, params, required=tuple(GROUP_MODULES))
    return jagent.core, params, agent.core


def latents(seed):
    return 2.0 * normal(seed, B, D)


# Inputs of the reference program, numpy from seeds.
Z, A = latents(1), np.tanh(normal(2, B, ACT_DIM))
TIME = np.linspace(0.0, 4.0, B).astype(np.float32)
UNIT_TIME = np.random.default_rng(11).random(B).astype(np.float32)
WEIGHTS = (1.0 + 0.5 * normal(27, 100)).astype(np.float32)
BIN_TIMES = np.array([0.01, 0.011, 0.5, 0.5, 0.999, 0.2, 0.2, 0.7], np.float32)
RETURNS = {batch: (normal(18, batch), normal(19, batch), normal(20, batch),
                   (np.arange(batch) == batch // 2).astype(np.float32)) for batch in (8, 3)}
OBS = normal(24, B, OBS_DIM)
KEYS = {name: jax.random.PRNGKey(seed) for seed, name in enumerate(
    ("decoder", "prior", "time", "act", "mlp"), start=40)}


def fe_score(z, time, o, lib):
    return lib.sin(z) * (1.0 + time[:, None]) - 0.1 * o


@pytest.fixture(scope="module")
def refs(setup):
    """Every JAX reference of this file, in one compiled program: tracing
    and compiling once is what keeps these tests cheap on the CPU. (The
    ELBO, EFE and MINE modules are held on the JAX train step's own inputs,
    by the program tests/test_torch_train.py compiles.)"""
    jcore, params, _ = setup
    rng = np.random.default_rng(3)
    stacked = jax.tree_util.tree_map(
        lambda x: np.stack([x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
                            for _ in range(3)]), params["dynamics"])
    mlps = {ln: jcommon.MLP(features=(16, 16, 3), use_layer_norm=ln) for ln in (False, True)}

    @fast_jit
    def reference(p, stacked):
        out = {"heads": {
            "value": jcore.apply_value(p["value"], Z, TIME),
            "dynamics": (jcore.predict_next_latent_members(p["dynamics"], Z, A),
                         *jcore.predict_next_latent(p["dynamics"], Z, A)),
            "reward": jcore.predict_reward(p["reward"], Z),
            "continuation": jcore.predict_continuation(p["continuation"], Z),
        }}
        out["ensemble"] = jax.vmap(
            lambda q: jcore.latent_dynamics.apply({"params": q}, Z, A))(stacked)

        def decoder_loss(dp):
            y = jcore.observation_decoder.apply({"params": dp}, Z, train=True,
                                                rngs={"dropout": KEYS["decoder"]})
            return jnp.sum(jnp.sin(y)), y

        (_, y), grads = jax.value_and_grad(decoder_loss, has_aux=True)(p["decoder"])
        out["decoder"] = dict(masks=dropout_masks(
            jcore.observation_decoder, {"params": p["decoder"]}, KEYS["decoder"], Z, train=True),
            out=y, grads=grads)
        d = p["diffusion"]
        out["diffusion"] = dict(
            log_snr=jdiff.compute_log_snr(d, UNIT_TIME),
            q=jdiff.continuous_q_sample(d, Z, UNIT_TIME, normal(13, B, D)),
            weight=jdiff.compute_loss_weight(d, UNIT_TIME),
            eps=jax.random.normal(KEYS["prior"], (B, D)),
            prior=jdiff.sample_latent_prior(d, KEYS["prior"], B))
        cat_key, jitter_key = jax.random.split(KEYS["time"])
        out["time"] = dict(
            bins=jax.random.categorical(cat_key, WEIGHTS, shape=(B,)),
            jitter=jax.random.uniform(jitter_key, (B,)),
            t=jtime.importance_sample_time(WEIGHTS, KEYS["time"], B),
            weights=jtime.update_time_importance(WEIGHTS, BIN_TIMES, normal(17, B) ** 2))
        out["returns"] = {batch: [jreturns.compute_lambda_returns(*r, 0.99, 0.95, 5, e)
                                  for e in (False, True)] for batch, r in RETURNS.items()}
        out["ema"] = {rm: jax.value_and_grad(lambda x, rm=rm: jepi.ema_loss(x, np.float32(rm)),
                                             has_aux=True)(normal(21, 40)) for rm in (0.0, 0.7)}
        out["belief"] = jcore.generate_beliefs(p, KEYS["act"], OBS, deterministic=True)
        out["start"] = jax.random.normal(jax.random.split(KEYS["act"])[0], (B, D))
        out["mish"] = jcommon.mish(OBS)
        mlp_params = {ln: m.init(KEYS["mlp"], OBS)["params"] for ln, m in mlps.items()}
        out["mlp"] = {ln: (mlp_params[ln], m.apply({"params": mlp_params[ln]}, OBS))
                      for ln, m in mlps.items()}
        log_precision = jfe.init_free_energy_state(2.0)
        f, info = jfe.compute_free_energy(log_precision, Z, OBS[:, :1] + Z, lambda *a: fe_score(
            *a, jnp), current_time=0.3)
        out["free_energy"] = dict(log_precision=log_precision, f=f, info=info,
                                  update=jfe.update_precision(0.2, info["complexity"],
                                                              info["accuracy"]))
        return out

    return stacked, jax.tree_util.tree_map(np.asarray, reference(params, stacked))


@pytest.mark.parametrize("head", ["value", "dynamics", "reward", "continuation"])
def test_heads_match_flax(setup, refs, head):
    tcore = setup[2]
    z, a, time = t(Z), t(A), t(TIME)
    got = {
        "value": lambda: tcore.apply_value(z, time),
        "dynamics": lambda: (tcore.predict_next_latent_members(z, a),
                             *tcore.predict_next_latent(z, a)),
        "reward": lambda: tcore.predict_reward(z),
        "continuation": lambda: tcore.predict_continuation(z),
    }[head]()
    want = refs[1]["heads"][head]
    for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
        close(g, w)


def test_dynamics_ensemble_matches_vmapped_flax(refs):
    """Three stacked members against the JAX core's vmapped apply."""
    model = LatentDynamicsModel(D, ACT_DIM, hidden_dim=H, members=3)
    load_flax_group(model, refs[0], "dynamics")
    close(model(t(Z), t(A)), refs[1]["ensemble"])


def test_reward_log_prob_matches_jax():
    mean, std, r = normal(6, B), np.exp(normal(7, B)), 3.0 * normal(8, B)
    close(reward_log_prob(t(mean), t(std), t(r)), jax_reward_log_prob(mean, std, r))


def test_decoder_dropout_matches_flax(setup, refs):
    """The decoder in training with the masks Flax draws from one key; the
    gradient of its output reaches the same parameters."""
    tcore = setup[2]
    ref = refs[1]["decoder"]
    masks = [torch.from_numpy(m) for m in ref["masks"]]
    assert [m.shape[1] for m in masks] == list(tcore.observation_decoder.widths)
    assert 0 < sum(int((~m).sum()) for m in masks)  # some units dropped
    decoder = tcore.observation_decoder
    decoder.zero_grad()
    out = decoder(t(Z), train=True, dropout_masks=masks)
    torch.sin(out).sum().backward()
    close(out, ref["out"])
    grads_close(decoder, ref["grads"], "decoder")


def test_continuous_diffusion_matches_jax(setup, refs):
    d, ref = setup[2].diffusion, refs[1]["diffusion"]
    close(tdiff.compute_log_snr(d, t(UNIT_TIME)), ref["log_snr"])
    got, info = tdiff.continuous_q_sample(d, t(Z), t(UNIT_TIME), t(normal(13, B, D)))
    want, jinfo = ref["q"]
    close(got, want)
    for name in ("log_snr", "alpha", "sigma"):
        close(info[name], jinfo[name], err_msg=name)
    close(tdiff.compute_loss_weight(d, t(UNIT_TIME)), ref["weight"])
    close(tdiff.sample_latent_prior(d, t(ref["eps"])), ref["prior"])


def test_time_sampler_matches_jax(refs):
    """Sampled times from the JAX draws, the bin update with several samples
    in one bin, and the port's own draw against the softmax."""
    ref = refs[1]["time"]
    bins = torch.from_numpy(ref["bins"].astype(np.int64))
    close(ttime.importance_sample_time(bins, t(ref["jitter"])), ref["t"])
    close(ttime.update_time_importance(t(WEIGHTS), t(BIN_TIMES), t(normal(17, B) ** 2)),
          ref["weights"])
    bins, jitter = ttime.draw_time(t(WEIGHTS), 4096, torch.Generator().manual_seed(0))
    freq = torch.bincount(bins, minlength=100).float() / 4096
    assert float((freq - torch.softmax(t(WEIGHTS), 0)).abs().max()) < 0.02
    assert 0.0 <= float(jitter.min()) and float(jitter.max()) < 1.0


@pytest.mark.parametrize("batch", [8, 3], ids=["batch8", "batch-shorter"])
def test_lambda_returns_match_jax(refs, batch):
    for exclude, want in zip((False, True), refs[1]["returns"][batch]):
        got = treturns.compute_lambda_returns(*(t(x) for x in RETURNS[batch]), 0.99, 0.95, 5,
                                              exclude)
        close(got, want)


@pytest.mark.parametrize("running_mean", [0.0, 0.7], ids=["first", "ema"])
def test_ema_logmeanexp_matches_jax(refs, running_mean):
    """The MINE marginal term, its EMA update and its bias-corrected
    gradient."""
    (value, new_rm), grad = refs[1]["ema"][running_mean]
    xt = t(normal(21, 40)).requires_grad_(True)
    got, got_rm = tepi.ema_loss(xt, torch.tensor(running_mean))
    got.backward()
    close(got, value)
    close(got_rm, new_rm)
    close(xt.grad, grad)


def test_reconstruction_error_matches_jax(setup, refs):
    """C2: ``generate_beliefs`` returns the decoded belief's mean squared
    error against the observation by default, as the JAX core does."""
    tcore, want = setup[2], refs[1]["belief"]
    start = t(refs[1]["start"])
    got = tcore.beliefs_from_start(t(OBS), start, torch.tensor(0), deterministic=True)
    assert float(want.reconstruction_error) > 0
    close(got.latent, want.latent)
    close(got.reconstruction_error, want.reconstruction_error)
    off = tcore.beliefs_from_start(t(OBS), start, torch.tensor(0), deterministic=True,
                                   compute_reconstruction=False)
    assert float(off.reconstruction_error) == 0.0


def test_act_efe_info_is_the_belief_and_efe(setup):
    """``act`` with EFE draws (``compute_efe_info``): the info holds the
    reconstruction error of the belief before refinement and the EFE of the
    policy on the refined belief, each the function held against JAX above;
    ``act(compute_efe_info=True)`` draws the start, then the EFE."""
    tcore = setup[2]
    obs = t(OBS)
    g = torch.Generator().manual_seed(5)
    start, efe = tcore.draw_start(B, g), tcore.draw_efe(B, g)
    action, info = tcore.act_from_start(obs, start, None, deterministic=True, efe=efe)
    belief = tcore.beliefs_from_start(obs, start.noise, start.seed,
                                      deterministic=tcore.config.deterministic_beliefs)
    temperature = torch.tensor(tcore.config.preference_temperature)
    with torch.no_grad():
        value, efe_info = tcore.compute_expected_free_energy(belief.latent, temperature, efe)
    assert set(info) == {"action_log_prob", "policy_entropy", "expected_free_energy",
                         "reconstruction_error", *efe_info}
    torch.testing.assert_close(info["reconstruction_error"], belief.reconstruction_error)
    torch.testing.assert_close(info["expected_free_energy"], value.mean())
    again, again_info = tcore.act(torch.Generator().manual_seed(5), obs, deterministic=True,
                                  compute_efe_info=True)
    assert torch.equal(again, action)
    torch.testing.assert_close(again_info["expected_free_energy"], info["expected_free_energy"])


def test_free_energy_matches_jax(refs):
    ref = refs[1]["free_energy"]
    close(tfe.init_free_energy_state(2.0), ref["log_precision"])
    got, info = tfe.compute_free_energy(torch.tensor(math.log(2.0)), t(Z), t(OBS[:, :1] + Z),
                                        lambda *a: fe_score(*a, torch), current_time=0.3)
    close(got, ref["f"])
    for name, value in ref["info"].items():
        close(info[name], value, err_msg=name)
    close(tfe.update_precision(torch.tensor(0.2), info["complexity"], info["accuracy"]),
          ref["update"])


def test_mlp_and_mish_match_flax(refs):
    close(tcommon.mish(t(OBS)), refs[1]["mish"])
    for layer_norm, (jparams, want) in refs[1]["mlp"].items():
        mlp = tcommon.MLP(OBS_DIM, (16, 16, 3), use_layer_norm=layer_norm)
        load_flax_group(mlp, jparams, "mlp")
        close(mlp(t(OBS)), want)


@pytest.mark.parametrize("case", ["clipped", "unclipped", "cosine"])
def test_optimizer_step_matches_optax(case):
    """Three updates of one partition's clip + AdamW against optax on the
    same gradients: global norms over and under the clip, and the policy's
    cosine-decayed rate."""
    rng = np.random.default_rng(31)
    shapes = {"w": (6, 4), "b": (4,), "s": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    grad_scale = {"clipped": 1.0, "unclipped": 0.01, "cosine": 1.0}[case]
    lr, wd, clip = 1e-3, 1e-5, 0.5
    schedule = CosineDecay(lr, 2, 0.1) if case == "cosine" else None
    opt = optax.chain(
        optax.clip_by_global_norm(clip),
        optax.adamw(optax.cosine_decay_schedule(lr, 2, 0.1) if schedule else lr,
                    weight_decay=wd),
    )
    state = opt.init(params)
    tparams = [torch.nn.Parameter(t(params[k])) for k in shapes]
    topt = PartitionOptimizer(tparams, lr, wd, clip, schedule)
    jparams = params
    for _ in range(3):
        grads = {k: np.asarray(grad_scale * rng.standard_normal(s), np.float32)
                 for k, s in shapes.items()}
        updates, state = opt.update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.step([t(grads[k]) for k in shapes])
        for p, k in zip(tparams, shapes):
            close(p, jparams[k], err_msg=k)


@pytest.mark.parametrize(
    "latent,hidden,dtype,takes",
    [(32, 128, torch.float32, True), (64, 256, torch.float32, True),
     (128, 96, torch.float32, True), (64, 384, torch.float32, False),
     (64, 384, torch.bfloat16, True), (128, 512, torch.float32, False),
     (128, 512, torch.bfloat16, True)],
    ids=["flagship", "humanoid", "h96", "h384-f32", "h384-bf16", "default-f32", "default-bf16"],
)
def test_sweep_gate_decides_per_width(latent, hidden, dtype, takes):
    """C1: at 6 DiT blocks the kernels take a width exactly where the JAX
    core's fused sweep does (``fused_sweep_supported``: 48 MiB of trunk
    weights); elsewhere the card runs the plain sweep. On the CPU the core
    never takes the kernel."""
    from active_inference_diffusion_tpu.ops.denoise import fused_sweep_supported

    size = 2 if dtype == torch.bfloat16 else 4
    assert kernel_takes(latent, hidden, 6, dtype) is takes
    assert fused_sweep_supported(hidden, latent, 6, bytes_per_param=size) is takes
    cfg = port_configs.ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=ACT_DIM, latent_dim=latent, hidden_dim=hidden,
        score_num_layers=1,
    )
    cfg.tpu.compute_dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert TorchCore(OBS_DIM, ACT_DIM, latent, cfg, device=CPU).sweep_uses_kernel is False


def test_init_params_follow_the_flax_initialisers():
    """``init_train_state`` initialises every group as Flax does: zero
    adaLN modulations and score head, the output multiplier at 1e-3, a
    residual dynamics head within 1e-3, unit LayerNorm scales, zero biases,
    lecun-normal kernels (std 1 / sqrt(fan_in)), orthogonal policy heads;
    and starts every optimizer at step 0."""
    agent = DiffusionStateAgent(OBS_DIM, ACT_DIM, port_config(tiny_config()),
                                port_config(TrainingConfig()), device=CPU)
    state = agent.init_train_state(0)
    core = agent.core.requires_grad_(False)
    net = core.score_network
    assert all(float(b.norm1.adaLN_modulation.weight.abs().max()) == 0 for b in net.blocks)
    assert float(net.out_fc2.weight.abs().max()) == 0
    assert float(net.output_multiplier) == pytest.approx(1e-3)
    assert float(core.latent_dynamics.out.weight.abs().max()) <= 1e-3
    assert float(core.diffusion.log_snr_min) == -10.0 and float(core.diffusion.log_snr_max) == 10.0
    assert float(core.epistemic_estimator.perturbation_scale) == pytest.approx(0.1)
    for m in core.modules():
        if isinstance(m, torch.nn.LayerNorm):
            assert bool((m.weight == 1).all()) and bool((m.bias == 0).all())
        if isinstance(m, torch.nn.Linear) and m.bias is not None:
            assert bool((m.bias == 0).all())
    w = core.epistemic_estimator.stats.proj_fc1.weight  # (512, 512) lecun-normal
    assert float(w.std()) == pytest.approx(1 / math.sqrt(w.shape[1]), rel=0.05)
    assert float(w.abs().max()) <= 2.0 / (0.87962566 * math.sqrt(w.shape[1])) + 1e-6
    q = core.policy_network.mean_fc2.weight  # (A, hidden/2): orthonormal rows
    torch.testing.assert_close(q @ q.T, torch.eye(q.shape[0]), rtol=0, atol=1e-5)
    assert state.step == 0 and all(o.count == 0 for o in state.optimizers.values())
    for name, p in core.score_network.named_parameters():
        assert torch.equal(state.ema_score[name], p)
