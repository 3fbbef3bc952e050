"""Port parity: checkpoints (``utils/checkpoints.py``) and ``train_fused``'s
checkpoint flow, on the CPU.

- ``adopt_checkpoint_semantics`` makes the JAX function's decision on the
  same ``meta.json`` files (the four cases of
  ``tests/test_resume_semantics.py``: an unpinned config adopts the
  checkpoint's convention, a differing pin wins with a warning, a legacy
  meta warns and keeps the current one, an equal one changes nothing). The
  files are the port's ``save_checkpoint``'s; an empty ``state`` directory
  beside them lets the JAX function's path resolver take the directory.
  Nothing is compiled.
- ``save_checkpoint`` writes the JAX package's meta keys, the resolved
  convention among them, and the ``latest`` alias.
- The round trip: a strict load into a template of another seed restores
  every parameter, optimizer moment, count and rate, EMA, the train
  state's fields and the generator's state, bitwise; the ring with its host
  mirrors likewise, and a ring of other shapes warns and stays fresh.
- The lenient restore: a checkpoint of one dynamics network loaded into a
  template of an ensemble of 3 keeps the template's dynamics group and the
  model partition's optimizer state and restores the rest
  (``tests/test_agent_train.py:799-829``); a checkpoint that differs only in
  optimizer state raises the strict error.
- ``train_fused.main`` on the CPU: two iterations with ``--checkpoint-dir
  --eval-every 1 --save-replay`` write ``best`` and ``final``; a resume of
  ``final`` restores the saved state and ring exactly, carries the step
  count and best eval, and its first update equals the update the saved
  run makes from there on the same ring and draws; a resume without a
  saved ring refills it with no update; the parser's defaults and errors.
"""

import json
import warnings

import numpy as np
import pytest
import torch

from active_inference_diffusion_tpu.configs.config import SemanticsConfig
from active_inference_diffusion_torch import train_fused
from active_inference_diffusion_torch.data.replay import replay_add_batch, replay_init
from active_inference_diffusion_torch.utils import checkpoints as tcheckpoints
from torch_parity import ACT_DIM, CPU, OBS_DIM, B, normal, port_config, tiny_config

JAX_META_KEYS = {"total_steps", "episode_count", "exploration_noise", "config",
                 "score_target_convention_resolved", "training_config"}


def agent_of(seed=0, **overrides):
    from active_inference_diffusion_torch.agents.state_agent import DiffusionStateAgent
    from active_inference_diffusion_torch.configs.config import TrainingConfig

    cfg = port_config(tiny_config(**overrides))
    agent = DiffusionStateAgent(OBS_DIM, ACT_DIM, cfg, TrainingConfig(buffer_size=16),
                                device=CPU)
    return agent, agent.init_train_state(seed)


def trained(agent, state, steps=2):
    """``steps`` updates, so the moments, counts and fields are off their start."""
    rng = np.random.default_rng(3)
    for _ in range(steps):
        batch = {"observations": normal(1, B, OBS_DIM), "next_observations": normal(2, B, OBS_DIM),
                 "actions": np.tanh(normal(3, B, ACT_DIM)), "rewards": normal(4, B),
                 "dones": (rng.random(B) < 0.3).astype(np.float32)}
        state, _ = agent.train_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return state


def tree_equal(a, b, path="") -> list:
    """The paths at which two checkpoint trees differ."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        return [p for k in a for p in tree_equal(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, list):
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in tree_equal(x, y, f"{path}/{i}")]
    if isinstance(a, torch.Tensor):
        return [] if torch.equal(a, b) else [path]
    return [] if a == b else [path]


# -- adopt_checkpoint_semantics ----------------------------------------------


@pytest.mark.parametrize("case", ["adopt", "pin-wins", "legacy", "equal"])
def test_adopt_checkpoint_semantics_matches_jax(case, tmp_path):
    agent, state = agent_of(semantics=SemanticsConfig(score_target_convention="reference"))
    path = tcheckpoints.save_checkpoint(str(tmp_path), agent, state, step=7, config=agent.config,
                                        name="best")
    (tmp_path / "best" / "state").mkdir()  # the JAX resolver's mark of a checkpoint
    if case == "legacy":
        mf = tmp_path / "best" / "meta.json"
        meta = json.loads(mf.read_text())
        meta.pop("score_target_convention_resolved")
        meta["config"]["semantics"]["score_target_convention"] = None
        mf.write_text(json.dumps(meta))
    # the JAX module imports orbax, which takes seconds: here, not at collection
    from active_inference_diffusion_tpu.utils import checkpoints as jcheckpoints

    pin = {"adopt": None, "pin-wins": "standard", "legacy": None, "equal": "reference"}[case]
    decided = []
    for cfg, adopt in ((tiny_config(), jcheckpoints.adopt_checkpoint_semantics),
                       (port_config(tiny_config()), tcheckpoints.adopt_checkpoint_semantics)):
        cfg.semantics.score_target_convention = pin
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            adopt(path, cfg)
        decided.append((cfg.semantics.score_target_convention, cfg.semantics.score_target_uses_std,
                        [w.category for w in caught]))
    assert decided[0] == decided[1]
    want = {"adopt": "reference", "pin-wins": "standard", "legacy": None, "equal": "reference"}
    assert decided[1][0] == want[case]
    assert bool(decided[1][2]) == (case in ("pin-wins", "legacy"))


def test_save_writes_the_jax_meta_keys_and_the_alias(tmp_path):
    agent, state = agent_of(semantics=SemanticsConfig(score_target_convention=None))
    path = tcheckpoints.save_checkpoint(str(tmp_path), agent, state, step=5, config=agent.config,
                                        training_config=agent.training_config,
                                        extra_meta={"eval_return": 1.5})
    assert path == str(tmp_path / "checkpoint_5")
    meta = json.loads((tmp_path / "checkpoint_5" / "meta.json").read_text())
    assert set(meta) == JAX_META_KEYS | {"eval_return"}
    assert meta["score_target_convention_resolved"] == "standard"  # the unpinned default
    assert tcheckpoints.resolve_checkpoint_path(str(tmp_path)) == tmp_path / "checkpoint_5"
    assert (tmp_path / "latest").resolve() == tmp_path / "checkpoint_5"


# -- the round trip and the lenient restore ----------------------------------


def test_round_trip_restores_every_field_bitwise(tmp_path):
    agent, state = agent_of(policy_lr_decay_steps=1, policy_anchor_weight=0.1)
    state = trained(agent, state)
    saved = tcheckpoints.train_state_dict(agent, state)
    tcheckpoints.save_checkpoint(str(tmp_path), agent, state, step=7, name="best")
    other, template = agent_of(seed=9, policy_lr_decay_steps=1, policy_anchor_weight=0.1)
    restored, meta = tcheckpoints.load_checkpoint(str(tmp_path / "best"), other, template)
    assert restored is template and meta["total_steps"] == 7
    assert tree_equal(saved, tcheckpoints.train_state_dict(other, restored)) == []
    assert restored.step == 2 and restored.ema_policy is not None
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    # the restored run draws and updates as the saved one
    assert torch.equal(torch.randn(3, generator=restored.rng), torch.randn(3, generator=state.rng))


def test_ring_round_trip_with_its_host_mirrors(tmp_path):
    agent, state = agent_of()
    ring = replay_init(16, (OBS_DIM,), ACT_DIM, device=CPU)
    for seed in (5, 6):  # 24 transitions: the ring wraps
        replay_add_batch(ring, torch.from_numpy(normal(seed, 12, OBS_DIM)),
                         torch.from_numpy(normal(seed + 10, 12, ACT_DIM)),
                         torch.from_numpy(normal(seed + 20, 12)),
                         torch.from_numpy(normal(seed + 30, 12, OBS_DIM)),
                         torch.arange(12) % 4 == 0)
    tcheckpoints.save_checkpoint(str(tmp_path), agent, state, step=1, name="final",
                                 replay_state=ring)
    template = replay_init(16, (OBS_DIM,), ACT_DIM, device=CPU)
    _, meta = tcheckpoints.load_checkpoint(str(tmp_path / "final"), *agent_of(),
                                           replay_template=template)
    assert meta["replay_state"] is template
    assert (template.host_pos, template.host_size, int(template.pos), int(template.size)) == (
        8, 16, 8, 16)
    assert tree_equal(tcheckpoints.replay_state_dict(ring),
                      tcheckpoints.replay_state_dict(template)) == []
    wider = replay_init(32, (OBS_DIM,), ACT_DIM, device=CPU)
    with pytest.warns(UserWarning, match="fresh buffer"):
        _, meta = tcheckpoints.load_checkpoint(str(tmp_path / "final"), *agent_of(),
                                               replay_template=wider)
    assert "replay_state" not in meta and wider.host_size == 0


def test_ensemble_resize_checkpoint_migration(tmp_path, capsys):
    agent1, state1 = agent_of()
    state1 = trained(agent1, state1, steps=1)
    tcheckpoints.save_checkpoint(str(tmp_path), agent1, state1, step=5)
    agent3, template = agent_of(seed=1, num_dynamics_ensemble=3)
    fresh_dynamics = [p.detach().clone() for p in agent3.core.latent_dynamics.parameters()]
    fresh_model_moment = template.optimizers["model"].adamw.state[
        template.optimizers["model"].params[0]]["exp_avg"].clone()
    restored, meta = tcheckpoints.load_checkpoint(str(tmp_path / "checkpoint_5"), agent3,
                                                  template)
    assert meta["total_steps"] == 5
    assert "params.dynamics" in capsys.readouterr().out
    for got, want in zip(agent3.core.latent_dynamics.parameters(), fresh_dynamics):
        assert torch.equal(got, want)  # reinitialised from the template (shapes changed)
    for got, want in zip(agent3.core.policy_network.parameters(),
                         agent1.core.policy_network.parameters()):
        assert torch.equal(got, want)  # restored from the save
    model = restored.optimizers["model"]
    assert torch.equal(model.adamw.state[model.params[0]]["exp_avg"], fresh_model_moment)
    score = restored.optimizers["score"]
    assert torch.equal(score.adamw.state[score.params[0]]["exp_avg"],
                       state1.optimizers["score"].adamw.state[
                           state1.optimizers["score"].params[0]]["exp_avg"])
    assert restored.step == 1


def test_a_checkpoint_differing_only_in_optimizer_state_raises(tmp_path):
    agent, state = agent_of()
    path = tcheckpoints.save_checkpoint(str(tmp_path), agent, state, step=3)
    tree = torch.load(f"{path}/state.pt", weights_only=True)
    tree["opt_states"]["value"]["exp_avg"][0] = torch.zeros(7, 3)
    torch.save(tree, f"{path}/state.pt")
    with pytest.raises(ValueError, match="does not match"):
        tcheckpoints.load_checkpoint(path, *agent_of())


# -- train_fused's checkpoint flow ------------------------------------------


BASE = ["--device", "cpu", "--num-envs", "4", "--steps-per-iter", "4", "--updates-per-iter", "2",
        "--batch-size", "8", "--latent-dim", "8", "--hidden-dim", "32", "--diffusion-steps", "4",
        "--train-epoch", "--eval-every", "1", "--eval-envs", "2"]


def test_train_fused_saves_resumes_and_refills(tmp_path):
    ckpt = tmp_path / "ckpt"
    first = train_fused.train(train_fused.build_run(train_fused.parse_args(
        BASE + ["--iterations", "2", "--log-dir", str(tmp_path), "--checkpoint-dir", str(ckpt),
                "--save-replay"])))
    assert {"best", "final"} <= {p.name for p in ckpt.iterdir()}
    meta = json.loads((ckpt / "final" / "meta.json").read_text())
    assert meta["total_steps"] == first.total_steps == 32 and meta["env"] == "Pendulum-v1"
    assert meta["eval_return"] == first.best_eval

    resumed = train_fused.build_run(train_fused.parse_args(
        BASE + ["--iterations", "1", "--log-dir", str(tmp_path), "--resume", str(ckpt / "final")]))
    assert resumed.restored_replay and resumed.total_steps == 32
    assert resumed.best_eval == first.best_eval
    assert tree_equal(tcheckpoints.train_state_dict(first.agent, first.state),
                      tcheckpoints.train_state_dict(resumed.agent, resumed.state)) == []
    assert tree_equal(tcheckpoints.replay_state_dict(first.replay),
                      tcheckpoints.replay_state_dict(resumed.replay)) == []
    # the first update after the resume is the update the saved run makes next
    for run in (first, resumed):
        run.state, _ = run.agent.train_epoch(run.state, run.replay, 1)
    assert tree_equal(tcheckpoints.train_state_dict(first.agent, first.state),
                      tcheckpoints.train_state_dict(resumed.agent, resumed.state)) == []

    (ckpt / "final" / "replay.pt").unlink()
    refill = train_fused.build_run(train_fused.parse_args(
        BASE + ["--iterations", "0", "--log-dir", str(tmp_path), "--resume", str(ckpt / "final"),
                "--resume-refill-steps", "40"]))
    assert not refill.restored_replay and refill.replay.host_size == 0
    step = refill.state.step
    train_fused.train(refill)
    assert refill.replay.host_size == 48 and refill.total_steps == 32 + 48
    assert refill.state.step == step  # no update while refilling


def test_train_fused_parser_matches_the_jax_script():
    args = train_fused.parse_args(["--device", "cpu"])
    assert args.resume_refill_steps == 8192 and not args.save_replay
    with pytest.raises(SystemExit):
        train_fused.parse_args(["--checkpoint-dir", "x"])
    with pytest.raises(NotImplementedError, match="A12"):
        train_fused.check_flags(train_fused.parse_args(["--video-every", "1"]))
