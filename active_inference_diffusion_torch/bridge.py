"""JAX parameters and train state -> the port's modules and train state.

The input is the JAX agent's parameter tree as a nested dict of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); this module never imports
JAX. Flax names map to torch names one to one, except:

- ``Dense.kernel`` (in, out) -> ``Linear.weight`` (out, in), transposed (the
  last two axes of a stacked kernel);
- ``LayerNorm.scale`` -> ``LayerNorm.weight``;
- ``block_<i>`` -> ``blocks.<i>``, ``trunk_fc<i>`` / ``trunk_ln<i>`` ->
  ``trunk_fc.<i>`` / ``trunk_ln.<i>`` (``nn.ModuleList`` entries);
- the ``epistemic`` group is a whole Flax variables dict: its ``params``
  level is dropped;
- the port's dynamics model is always a stacked ensemble: a single JAX
  network (``num_dynamics_ensemble`` 1) gets a leading member axis of 1.

Every leaf of a loaded group must map onto a parameter of the right shape,
and every parameter must be filled; anything else raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .core.active_inference import GROUP_MODULES

# The JAX parameter groups this port loads, and the core module each fills.
PORTED_GROUPS = GROUP_MODULES
# The groups acting needs; ``load_jax_params`` requires them by default.
ACTING_GROUPS = ("score", "policy", "decoder")
# Groups the JAX agent holds that later ports will load.
UNPORTED_GROUPS = ("feature_decoder",)

_MODULE_RENAMES = (
    (re.compile(r"^block_(\d+)$"), r"blocks.\1"),
    (re.compile(r"^trunk_(fc|ln)(\d+)$"), r"trunk_\1.\2"),
)


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def torch_name(path: Tuple[str, ...]) -> Tuple[str, bool]:
    """(torch parameter name, transpose?) for a Flax leaf path."""
    *modules, leaf = path
    names = []
    for m in modules:
        for pattern, repl in _MODULE_RENAMES:
            m = pattern.sub(repl, m)
        names.append(m)
    if leaf == "kernel":
        return ".".join(names + ["weight"]), True
    if leaf == "scale":
        return ".".join(names + ["weight"]), False
    return ".".join(names + [leaf]), False


def flax_to_torch(tree: Mapping, add_member_axis: bool = False) -> Dict[str, np.ndarray]:
    """A Flax parameter tree as torch-named arrays in torch's layout;
    ``add_member_axis`` puts a leading axis of 1 on every leaf."""
    out = {}
    for path, value in _flatten(tree).items():
        name, transpose = torch_name(path)
        array = np.swapaxes(value, -1, -2) if transpose else value
        out[name] = array[None] if add_member_axis else array
    return out


def group_arrays(module: nn.Module, tree: Mapping, group: str) -> Dict[str, np.ndarray]:
    """One Flax parameter group (or a tree of its shape, such as an Adam
    moment) as arrays named and laid out as ``module``'s parameters."""
    if group == "epistemic":
        tree = tree["params"]
    return flax_to_torch(tree, add_member_axis=group == "dynamics" and module.members == 1)


def load_flax_group(module: nn.Module, tree: Mapping, group: str) -> None:
    """Copy one Flax parameter group into ``module``'s parameters."""
    params = dict(module.named_parameters())
    filled = set()
    for name, array in group_arrays(module, tree, group).items():
        if name not in params:
            raise KeyError(f"unmapped JAX parameter {group}/{name} (no torch parameter {name!r})")
        target = params[name]
        if tuple(array.shape) != tuple(target.shape):
            raise ValueError(
                f"{group}/{name}: shape {tuple(array.shape)} does not fit {tuple(target.shape)}"
            )
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.array(array, dtype=np.float32)))
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"JAX group {group!r} left torch parameters unfilled: {missing}")


def load_jax_params(
    core: nn.Module, params: Mapping, required: Sequence[str] = ACTING_GROUPS
) -> Tuple[str, ...]:
    """Load every ported group of a JAX parameter tree that is there into a
    ``DiffusionActiveInference``; raise where a ``required`` group is
    missing or a group is unknown. Returns the groups left for later
    ports."""
    unknown = sorted(set(params) - set(PORTED_GROUPS) - set(UNPORTED_GROUPS))
    if unknown:
        raise KeyError(f"unknown JAX parameter groups: {unknown}")
    for group in required:
        if group not in params:
            raise KeyError(f"JAX parameter tree has no {group!r} group")
    for group, attr in PORTED_GROUPS.items():
        if group in params:
            load_flax_group(getattr(core, attr), params[group], group)
    return tuple(g for g in UNPORTED_GROUPS if g in params)


def train_state_from_jax(agent, jax_state, seed: int = 0):
    """The port's ``AgentTrainState`` for ``agent`` from the JAX agent's
    ``init_train_state`` output with numpy leaves
    (``jax.tree_util.tree_map(np.asarray, state)``). Loads every ported
    parameter group into the agent's core; the optimizers start at zero
    moments, as the JAX state's do at step 0; ``time_importance``,
    ``reward_norm``, ``epistemic_running_mean``, ``preference_temperature``,
    ``return_scale``, ``log_alpha`` and the EMAs (the score EMA, the slow
    critic ``target_value`` and, where the state holds one, the EMA policy)
    are carried over; ``rng`` is a new generator seeded with ``seed``.
    Raises for a state past step 0, whose moments would be lost, and where
    the JAX state holds an EMA policy and the port's does not, or the other
    way round."""
    if int(np.asarray(jax_state.step)) != 0:
        raise ValueError("only a step-0 JAX train state maps over: optimizer moments are not carried")
    load_jax_params(agent.core, jax_state.params, required=tuple(PORTED_GROUPS))
    state = agent.new_train_state(seed)
    dev = agent.device

    def tensor(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    def ema(tree, group: str, like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        arrays = flax_to_torch(tree)
        if set(arrays) != set(like):
            raise KeyError(f"the JAX {group} EMA does not map onto the network's parameters")
        return {name: tensor(arrays[name]) for name in like}

    state.ema_score = ema(jax_state.ema_score, "score", state.ema_score)
    state.target_value = ema(jax_state.target_value, "value", state.target_value)
    if (jax_state.ema_policy is None) != (state.ema_policy is None):
        raise ValueError("the JAX state and the port's config disagree on the EMA policy")
    if state.ema_policy is not None:
        state.ema_policy = ema(jax_state.ema_policy, "policy", state.ema_policy)
    state.return_scale = tensor(jax_state.return_scale)
    state.log_alpha = tensor(jax_state.log_alpha)
    state.time_importance = tensor(jax_state.time_importance)
    norm = jax_state.reward_norm
    state.reward_norm = type(state.reward_norm)(tensor(norm.mean), tensor(norm.var),
                                                tensor(norm.count))
    state.epistemic_running_mean = tensor(jax_state.epistemic_running_mean)
    state.preference_temperature = tensor(jax_state.preference_temperature)
    return state
