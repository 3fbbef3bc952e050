"""Exponential moving average of parameters.

Counterpart of ``active_inference_diffusion_tpu/models/ema.py``: the shadow
is a dict of tensors keyed by parameter name.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
from torch import nn


def init_ema(module: nn.Module) -> Dict[str, torch.Tensor]:
    """A copy of ``module``'s parameters, detached, in distinct storage."""
    return {name: p.detach().clone() for name, p in module.named_parameters()}


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], module: nn.Module, decay: float = 0.9999) -> None:
    """shadow <- decay * shadow + (1 - decay) * params, in place."""
    for name, p in module.named_parameters():
        ema[name].copy_(decay * ema[name] + (1.0 - decay) * p)


def shadow_module(module: nn.Module, ema: Dict[str, torch.Tensor]) -> nn.Module:
    """A module of ``module``'s structure whose parameters are the tensors of
    ``ema`` themselves, not copies: it computes with the shadow as it stands,
    and an in-place EMA update moves it. It shares no cache with ``module``
    (a weight pack cached on one is never the other's)."""
    names = dict(module.named_parameters())
    if set(names) != set(ema):
        raise KeyError("the EMA does not map onto the module's parameters")
    memo = {id(p): ema[name] for name, p in names.items()}
    if "_packed_trunks" in module.__dict__:
        memo[id(module.__dict__["_packed_trunks"])] = {}
    return copy.deepcopy(module, memo)
