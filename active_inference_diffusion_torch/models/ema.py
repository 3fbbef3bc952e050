"""Exponential moving average of parameters.

Counterpart of ``active_inference_diffusion_tpu/models/ema.py``: the shadow
is a dict of tensors keyed by parameter name.
"""

from __future__ import annotations

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
