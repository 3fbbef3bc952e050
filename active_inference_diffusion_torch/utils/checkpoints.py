"""Checkpoints: the parameters, the whole train state, the replay ring and
the run's metadata, as torch state dicts.

Counterpart of ``active_inference_diffusion_tpu/utils/checkpoints.py``
(``save_checkpoint`` :26, ``resolve_checkpoint_path`` :94,
``_lenient_restore`` :110-202, ``adopt_checkpoint_semantics`` :205-262,
``load_checkpoint`` :263-313), which writes orbax trees; this module writes
``torch.save`` files of plain containers (dicts, lists, tensors, numbers)
and reads them back with ``torch.load(..., weights_only=True)``. A
checkpoint directory holds ``state.pt`` (every parameter group of the
agent's core and every field of ``AgentTrainState``: each partition's AdamW
moments, step counts, update count and scheduled rate, both EMAs and the EMA policy,
the return scale, log alpha, the time importance, the MINE running mean,
the reward normaliser, the preference temperature, the host step and the
state of the ``rng`` generator), optionally ``replay.pt`` (the device ring
with its host mirrors), and ``meta.json`` with the JAX package's keys.
Reading an orbax checkpoint of the JAX package is not supported.

A restore writes into the template's own tensors in place, so the
parameters, moments and ring keep their storage (a captured CUDA graph and
the optimizers go on reading them) and land on the template's device.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..configs.config import config_to_dict
from ..core.active_inference import GROUP_MODULES
from ..data.replay import ReplayState

STATE_FILE, REPLAY_FILE, META_FILE = "state.pt", "replay.pt", "meta.json"
_RING_FIELDS = ("observations", "actions", "rewards", "next_observations", "dones", "pos", "size")
_SCALARS = ("return_scale", "log_alpha", "time_importance", "epistemic_running_mean",
            "preference_temperature")
_MOMENTS = ("step", "exp_avg", "exp_avg_sq")


def _cpu(tree):
    """A copy of a tree of tensors (dicts, lists, None, numbers) on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_cpu(v) for v in tree]
    return tree


def _optimizer_state(opt) -> Dict[str, Any]:
    return {"count": opt.count, "lr": opt.lr,
            **{k: [opt.adamw.state[p][k] for p in opt.params] for k in _MOMENTS}}


def _state_tree(agent, state) -> Dict[str, Any]:
    """Every parameter group of ``agent``'s core (by JAX group name, then
    the module's parameter name) and every field of ``state``: the live
    tensors in plain containers."""
    core = agent.core
    norm = state.reward_norm
    return {
        "params": {g: dict(getattr(core, m).named_parameters()) for g, m in GROUP_MODULES.items()},
        "opt_states": {name: _optimizer_state(opt) for name, opt in state.optimizers.items()},
        "step": state.step,
        "ema_score": state.ema_score,
        "target_value": state.target_value,
        "ema_policy": state.ema_policy,
        **{name: getattr(state, name) for name in _SCALARS},
        "reward_norm": {"mean": norm.mean, "var": norm.var, "count": norm.count},
        "rng": state.rng.get_state(),
    }


def _ring_tree(replay: ReplayState) -> Dict[str, Any]:
    return {**{f: getattr(replay, f) for f in _RING_FIELDS},
            "host_pos": replay.host_pos, "host_size": replay.host_size}


def train_state_dict(agent, state) -> Dict[str, Any]:
    """``agent``'s parameters and the whole train ``state`` as plain
    containers of CPU tensor copies: what ``state.pt`` holds."""
    return _cpu(_state_tree(agent, state))


def replay_state_dict(replay: ReplayState) -> Dict[str, Any]:
    """The ring's tensors as CPU copies and its host mirrors: what
    ``replay.pt`` holds."""
    return _cpu(_ring_tree(replay))


def save_checkpoint(
    checkpoint_dir: str,
    agent,
    state,
    step: int,
    episode_count: int = 0,
    exploration_noise: float = 0.0,
    config=None,
    training_config=None,
    keep_latest_alias: bool = True,
    replay_state: Optional[ReplayState] = None,
    name: Optional[str] = None,
    extra_meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Save ``agent``'s parameters and the whole train ``state`` (and with
    ``replay_state`` the ring) to ``checkpoint_<step>``, or to ``name``
    (``"best"``, ``"final"``: overwritten in place), with ``meta.json``:
    ``total_steps``, ``episode_count``, ``exploration_noise``, the
    ``config`` and its resolved ``score_target_convention_resolved``, the
    ``training_config``, and ``extra_meta`` merged in. Refreshes the
    ``latest.txt`` / ``latest`` alias unless told not to. Returns the
    checkpoint's path."""
    ckpt_dir = Path(checkpoint_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / (name if name is not None else f"checkpoint_{step}")
    path.mkdir(exist_ok=True)
    torch.save(train_state_dict(agent, state), path / STATE_FILE)
    if replay_state is not None:
        torch.save(replay_state_dict(replay_state), path / REPLAY_FILE)

    meta = {"total_steps": step, "episode_count": episode_count,
            "exploration_noise": exploration_noise}
    if config is not None:
        meta["config"] = config_to_dict(config)
        sem = getattr(config, "semantics", None)
        if sem is not None:
            # the resolved convention: an unpinned (None) field meant another
            # convention before the JAX package's default flip
            meta["score_target_convention_resolved"] = (
                "standard" if sem.score_target_uses_std else "reference")
    if training_config is not None:
        meta["training_config"] = config_to_dict(training_config)
    if extra_meta:
        meta.update(extra_meta)
    with open(path / META_FILE, "w") as f:
        json.dump(meta, f, indent=2, default=str)

    if keep_latest_alias:
        latest = ckpt_dir / "latest"
        (ckpt_dir / "latest.txt").write_text(str(path))
        try:
            if latest.is_symlink() or latest.exists():
                latest.unlink()
            latest.symlink_to(path)
        except OSError:
            pass
    return str(path)


def resolve_checkpoint_path(path_or_dir: str) -> Path:
    """A checkpoint directory itself, a checkpoints root (its ``latest.txt``,
    else its highest ``checkpoint_<step>``), or a ``latest`` alias."""
    p = Path(path_or_dir).absolute()
    if (p / STATE_FILE).exists():
        return p
    if (p / "latest.txt").exists():
        return Path((p / "latest.txt").read_text().strip())
    candidates = sorted(p.glob("checkpoint_*"), key=lambda c: int(c.name.split("_")[-1]))
    if candidates:
        return candidates[-1]
    raise FileNotFoundError(f"No checkpoint found under {path_or_dir}")


def adopt_checkpoint_semantics(path_or_dir: str, config) -> None:
    """Reconcile the score-target convention of a checkpoint and the run's
    config before the agent is built, from ``meta.json`` alone: a config
    that does not pin ``score_target_convention`` adopts the checkpoint's
    (in place); a pin that differs wins, with a warning; a checkpoint that
    recorded none (legacy) resumes under the current one, with a warning;
    equal conventions change nothing."""
    try:
        path = resolve_checkpoint_path(path_or_dir)
    except FileNotFoundError:
        return
    meta_file = path / META_FILE
    if not meta_file.exists():
        return
    meta = json.loads(meta_file.read_text())
    saved = meta.get("score_target_convention_resolved")
    if saved is None:  # may still be None for legacy unpinned checkpoints
        saved = (meta.get("config") or {}).get("semantics", {}).get("score_target_convention")
    sem = getattr(config, "semantics", None)
    if sem is None:
        return
    current = "standard" if sem.score_target_uses_std else "reference"
    if saved is None:
        warnings.warn(
            f"checkpoint {path} predates score-target-convention persistence and its config "
            f"did not pin one; resuming under the current convention ({current!r}). If the "
            "checkpoint was trained before the default flip, pass score_target_convention: "
            "reference explicitly.")
        return
    if saved == current:
        return
    if sem.score_target_convention is None:
        sem.score_target_convention = saved
        print(f"resume: adopting the checkpoint's score-target convention {saved!r} (run config "
              f"left it unpinned; current default is {current!r}) so the training objective is "
              "unchanged across the resume", flush=True)
    else:
        warnings.warn(
            f"checkpoint {path} was trained under score_target_convention={saved!r} but the run "
            f"config pins {current!r}: the score target scale will CHANGE at resume (config pin "
            "wins).")


def _same_structure(saved, template) -> bool:
    """True when two trees have the same containers, keys and lengths, and
    tensors of the same shape and type in the same places."""
    if isinstance(template, torch.Tensor):
        return (isinstance(saved, torch.Tensor) and saved.shape == template.shape
                and saved.dtype == template.dtype)
    if isinstance(template, dict):
        return (isinstance(saved, dict) and saved.keys() == template.keys()
                and all(_same_structure(saved[k], template[k]) for k in template))
    if isinstance(template, (list, tuple)):
        return (isinstance(saved, (list, tuple)) and len(saved) == len(template)
                and all(_same_structure(s, t) for s, t in zip(saved, template)))
    if template is None or saved is None:
        return template is None and saved is None
    return isinstance(saved, (int, float)) == isinstance(template, (int, float))


@torch.no_grad()
def _copy(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    for k, t in dst.items():
        t.copy_(src[k])


def _merge(saved: Dict[str, Any], template: Dict[str, Any]) -> Tuple[Dict[str, Any], List[str]]:
    """The restore of JAX's ``_lenient_restore``: per parameter group, per
    optimizer partition and per state field, the saved value where its
    names and shapes match the template's, else the template's, listed as
    dropped. The score EMA and the slow critic restart from the restored
    live networks where theirs were dropped."""
    out: Dict[str, Any] = {}
    dropped: List[str] = []
    for label in ("params", "opt_states"):
        groups = saved.get(label) if isinstance(saved.get(label), dict) else {}
        out[label] = {}
        for k, tv in template[label].items():
            if k in groups and _same_structure(groups[k], tv):
                out[label][k] = groups[k]
            else:
                out[label][k] = tv
                dropped.append(f"{label}.{k}")
    for name, live in (("ema_score", out["params"]["score"]),
                       ("target_value", out["params"]["value"])):
        if name in saved and _same_structure(saved[name], template[name]):
            out[name] = saved[name]
        else:
            out[name] = {k: v.clone() for k, v in live.items()}
            dropped.append(name)
    for name, tv in template.items():
        if name in out:
            continue
        if name in saved and _same_structure(saved[name], tv):
            out[name] = saved[name]
        else:
            out[name] = tv
            dropped.append(name)
    return out, dropped


@torch.no_grad()
def _restore(agent, state, tree: Dict[str, Any]) -> None:
    """Writes a complete train-state tree into ``agent``'s modules and
    ``state``'s own tensors."""
    core = agent.core
    for group, module in GROUP_MODULES.items():
        _copy(dict(getattr(core, module).named_parameters()), tree["params"][group])
    for name, opt in state.optimizers.items():
        saved = tree["opt_states"][name]
        opt.count = int(saved["count"])
        if opt.lr is not None:
            opt.lr.copy_(saved["lr"])
        for i, p in enumerate(opt.params):
            for k in _MOMENTS:
                opt.adamw.state[p][k].copy_(saved[k][i])
    state.step = int(tree["step"])
    for name in ("ema_score", "target_value"):
        _copy(getattr(state, name), tree[name])
    if state.ema_policy is not None:
        _copy(state.ema_policy, tree["ema_policy"])
    for name in _SCALARS:
        getattr(state, name).copy_(tree[name])
    for k in ("mean", "var", "count"):
        getattr(state.reward_norm, k).copy_(tree["reward_norm"][k])
    state.rng.set_state(tree["rng"])


def load_checkpoint(
    path_or_dir: str, agent, template_state, replay_template: Optional[ReplayState] = None
) -> Tuple[Any, Dict[str, Any]]:
    """Restore ``agent``'s parameters and ``template_state`` from a
    checkpoint (written in place, and the state returned) with the host
    metadata dict. A checkpoint whose every name and shape matches the
    template restores strictly; otherwise leniently (``_merge``), printing
    what restarts from the template, and if nothing but optimizer state
    would be dropped the strict error is raised (the mismatch is then a
    fault, not a change of structure). With ``replay_template``, a saved
    ring of the same shapes is written into it and returned in the
    metadata under ``"replay_state"``; one of other shapes warns and is
    left out (the caller refills)."""
    path = resolve_checkpoint_path(path_or_dir)
    saved = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)
    template = _state_tree(agent, template_state)
    if _same_structure(saved, template):
        tree = saved
    else:
        strict = ValueError(f"checkpoint {path} does not match the template state's names and "
                            "shapes")
        tree, dropped = _merge(saved, template)
        if not any(not d.startswith("opt_states") for d in dropped):
            raise strict
        print("load_checkpoint: structure drift, reinitialized from template: "
              + ", ".join(dropped))
    _restore(agent, template_state, tree)

    meta: Dict[str, Any] = {}
    if (path / META_FILE).exists():
        meta = json.loads((path / META_FILE).read_text())
    if replay_template is not None and (path / REPLAY_FILE).exists():
        ring = torch.load(path / REPLAY_FILE, map_location="cpu", weights_only=True)
        if _same_structure(ring, _ring_tree(replay_template)):
            with torch.no_grad():
                for f in _RING_FIELDS:
                    getattr(replay_template, f).copy_(ring[f])
            replay_template.host_pos = int(ring["host_pos"])
            replay_template.host_size = int(ring["host_size"])
            meta["replay_state"] = replay_template
        else:
            warnings.warn("checkpointed replay buffer does not match the current template; "
                          "resuming with a fresh buffer")
    return template_state, meta
