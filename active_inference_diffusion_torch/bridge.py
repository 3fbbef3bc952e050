"""JAX parameters -> the port's modules.

The input is the JAX agent's parameter tree as a nested dict of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); this module never imports
JAX. Flax names map to torch names one to one, except:

- ``Dense.kernel`` (in, out) -> ``Linear.weight`` (out, in), transposed;
- ``LayerNorm.scale`` -> ``LayerNorm.weight``;
- ``block_<i>`` -> ``blocks.<i>``, ``trunk_fc<i>`` / ``trunk_ln<i>`` ->
  ``trunk_fc.<i>`` / ``trunk_ln.<i>`` (``nn.ModuleList`` entries).

Every leaf of the ported groups must map onto a parameter of the right
shape, and every parameter must be filled; anything else raises.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# Groups of the JAX parameter tree this port loads, and the module each fills.
PORTED_GROUPS = {"score": "score_network", "policy": "policy_network"}
# Groups the JAX agent holds that later ports will load (training and the
# heads beyond acting).
UNPORTED_GROUPS = (
    "diffusion", "value", "dynamics", "decoder", "reward", "continuation",
    "posterior", "epistemic", "feature_decoder",
)

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


def load_flax_group(module: nn.Module, tree: Mapping, group: str) -> None:
    """Copy one Flax parameter group into ``module``'s parameters."""
    params = dict(module.named_parameters())
    filled = set()
    for path, value in _flatten(tree).items():
        name, transpose = torch_name(path)
        where = f"{group}/{'/'.join(path)}"
        if name not in params:
            raise KeyError(f"unmapped JAX parameter {where} (no torch parameter {name!r})")
        array = value.T if transpose else value
        target = params[name]
        if tuple(array.shape) != tuple(target.shape):
            raise ValueError(
                f"{where}: shape {tuple(array.shape)} does not fit {name} {tuple(target.shape)}"
            )
        with torch.no_grad():
            target.copy_(torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)))
        filled.add(name)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"JAX group {group!r} left torch parameters unfilled: {missing}")


def load_jax_params(core: nn.Module, params: Mapping) -> Tuple[str, ...]:
    """Load the ported groups of a JAX parameter tree into a
    ``DiffusionActiveInference``; return the groups left for later ports.
    Raises on a group it does not know."""
    unknown = sorted(set(params) - set(PORTED_GROUPS) - set(UNPORTED_GROUPS))
    if unknown:
        raise KeyError(f"unknown JAX parameter groups: {unknown}")
    for group, attr in PORTED_GROUPS.items():
        if group not in params:
            raise KeyError(f"JAX parameter tree has no {group!r} group")
        load_flax_group(getattr(core, attr), params[group], group)
    return tuple(g for g in UNPORTED_GROUPS if g in params)
