"""Port parity: score network, policy and the parameter bridge against the
Flax modules on bridged weights, at rtol 2e-4 / atol 2e-5 (float32 both
sides; only the summation order differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.models.policy import sample_action as jax_sample_action
from active_inference_diffusion_torch.bridge import (
    UNPORTED_GROUPS,
    load_flax_group,
    load_jax_params,
)
from active_inference_diffusion_torch.models.policy import sample_action
from torch_parity import (
    B,
    D,
    MODEL_TOL,
    OBS_DIM,
    jax_core_and_params,
    normal,
    t,
    tiny_config,
    torch_core,
)


@pytest.fixture(scope="module")
def cores():
    cfg = tiny_config()
    jcore, params = jax_core_and_params(cfg)
    return jcore, params, torch_core(cfg, params)


def score_apply(jcore, params, *args, **kw):
    return np.asarray(
        jcore.score_network.apply({"params": params["score"]}, *args, **kw)
    )


def close(got, expected):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(expected), **MODEL_TOL)


def test_obs_embedding_matches_flax(cores):
    jcore, params, tcore = cores
    obs = normal(0, B, OBS_DIM)
    close(
        tcore.score_network.obs_embedding(t(obs)),
        score_apply(jcore, params, obs, method="obs_embedding"),
    )


@pytest.mark.parametrize("continuous", [True, False])
def test_time_embedding_matches_flax(cores, continuous):
    jcore, params, tcore = cores
    # continuous times in (0, 1]; discrete raw timesteps K-1..0 as float
    times = (
        np.random.default_rng(1).uniform(0.01, 1.0, 7).astype(np.float32)
        if continuous
        else np.arange(4, -1, -1).astype(np.float32)
    )
    close(
        tcore.score_network.time_embedding(t(times), continuous=continuous),
        score_apply(jcore, params, times, continuous=continuous, method="time_embedding"),
    )


def test_trunk_matches_flax(cores):
    jcore, params, tcore = cores
    z, cond = normal(2, B, D), normal(3, B, tcore.score_network.hidden_dim)
    close(
        tcore.score_network.trunk(t(z), t(cond)),
        score_apply(jcore, params, z, cond, None, method="trunk"),
    )


@pytest.mark.parametrize("continuous", [True, False])
def test_score_call_matches_flax(cores, continuous):
    jcore, params, tcore = cores
    z, obs = normal(4, B, D), normal(5, B, OBS_DIM)
    times = (
        np.random.default_rng(6).uniform(0.01, 1.0, B).astype(np.float32)
        if continuous
        else np.arange(B).astype(np.float32)
    )
    close(
        tcore.score_network(t(z), t(times), t(obs), continuous=continuous),
        score_apply(jcore, params, z, times, obs, continuous=continuous, train=False),
    )


@pytest.mark.parametrize(
    "group,path", [("score", "obs_ln1"), ("policy", "enc_ln"), ("policy", "trunk_ln0"),
                   ("score", "block_0/norm1")],
)
def test_layer_norm_epsilon_matches_flax(cores, group, path):
    """Inputs with variance ~1e-6, where eps 1e-6 (Flax) and 1e-5 (torch's
    default) give visibly different outputs."""
    from flax import linen as fnn

    from active_inference_diffusion_tpu.models.common import AdaptiveLayerNorm

    _, params, tcore = cores
    tree = params[group]
    for key in path.split("/"):
        tree = tree[key]
    x = 1e-3 * normal(10, B, tcore.score_network.hidden_dim)
    if path.endswith("norm1"):
        cond = normal(11, B, tcore.score_network.hidden_dim)
        expected = AdaptiveLayerNorm(x.shape[-1]).apply({"params": tree}, x, cond)
        got = tcore.score_network.blocks[0].norm1(t(x), t(cond))
    else:
        expected = fnn.LayerNorm().apply({"params": tree}, x)
        module = tcore.get_submodule(
            {"score": "score_network.", "policy": "policy_network."}[group]
            + path.replace("trunk_ln0", "trunk_ln.0")
        )
        got = module(t(x))
    close(got, expected)


def test_policy_distribution_matches_flax(cores):
    jcore, params, tcore = cores
    z = 2.0 * normal(7, B, D)
    expected = jcore.apply_policy(params["policy"], z)
    got = tcore.apply_policy(t(z))
    close(got.mean, expected.mean)
    close(got.log_std, expected.log_std)
    close(got.entropy(), expected.entropy())


@pytest.mark.parametrize("deterministic,squash", [(True, True), (False, True), (False, False)])
def test_sample_action_matches_flax(cores, deterministic, squash):
    jcore, params, tcore = cores
    z = normal(8, B, D)
    key = jax.random.PRNGKey(9)
    jdist = jcore.apply_policy(params["policy"], z)
    action, log_prob = jax_sample_action(jdist, key, deterministic=deterministic, squash=squash)
    # the standard normal the JAX sample drew (PolicyDist.sample)
    eps = np.asarray(jax.random.normal(key, jdist.mean.shape, dtype=jnp.float32))
    got_action, got_log_prob = sample_action(
        tcore.apply_policy(t(z)), t(eps), deterministic=deterministic, squash=squash
    )
    close(got_action, action)
    close(got_log_prob, log_prob)


# ----------------------------- the bridge ----------------------------------


def _leaves(tree):
    return len(jax.tree_util.tree_leaves(tree))


def test_bridge_consumes_every_leaf(cores):
    _, params, tcore = cores
    # each torch parameter is filled from exactly one Flax leaf, and back
    assert _leaves(params["score"]) == len(list(tcore.score_network.parameters()))
    assert _leaves(params["policy"]) == len(list(tcore.policy_network.parameters()))
    # the groups of the JAX agent's tree that later ports load are left
    later = {g: {"w": np.zeros(1, np.float32)} for g in ("value", "epistemic")}
    assert load_jax_params(tcore, {**params, **later}) == ("value", "epistemic")
    assert set(later) <= set(UNPORTED_GROUPS)


def test_bridge_raises_on_unmapped_leaf_and_group(cores):
    _, params, tcore = cores
    score = dict(params["score"])
    score["extra_head"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="extra_head"):
        load_flax_group(tcore.score_network, score, "score")
    with pytest.raises(KeyError, match="unfilled"):
        load_flax_group(
            tcore.policy_network,
            {k: v for k, v in params["policy"].items() if k != "std_fc2"},
            "policy",
        )
    with pytest.raises(KeyError, match="unknown JAX parameter groups"):
        load_jax_params(tcore, {**params, "mystery": {}})
    bad = dict(params["policy"])
    bad["mean_fc2"] = {"kernel": np.zeros((3, 3), np.float32), "bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load_flax_group(tcore.policy_network, bad, "policy")
