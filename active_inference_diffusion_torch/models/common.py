"""Shared building blocks: activations, dropout from given masks, the Flax
initialisers, the sinusoidal time embedding, adaptive LayerNorm and an MLP.

Counterpart of ``active_inference_diffusion_tpu/models/common.py``.
LayerNorm epsilon is 1e-6 (the Flax default), not torch's 1e-5.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
# Flax's truncated normal: the std of a unit normal cut at +-2.
_TRUNC_STD = 0.87962566103423978


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation: x * tanh(softplus(x))."""
    return x * torch.tanh(F.softplus(x))


def dropout(x: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Flax's ``nn.Dropout`` with its Bernoulli keep-mask given: kept units
    scaled by 1 / (1 - rate), the others 0. ``keep`` None is the identity
    (evaluation). The mask is a draw of the caller's, never of a hidden
    generator."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


# -- initialisers (Flax's, on torch's (out, in) weight layout) ------------


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Flax's default Dense kernel init: variance 1/fan_in, truncated at
    two standard deviations."""
    std = (1.0 / weight.shape[-1]) ** 0.5 / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def xavier_uniform_(weight: torch.Tensor, generator: torch.Generator) -> None:
    nn.init.xavier_uniform_(weight, generator=generator)


def orthogonal_init(gain: float = 1.0) -> Callable[[torch.Tensor, torch.Generator], None]:
    def init(weight: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.orthogonal_(weight, gain, generator=generator)

    return init


def small_uniform_init(scale: float = 1e-3) -> Callable[[torch.Tensor, torch.Generator], None]:
    def init(weight: torch.Tensor, generator: torch.Generator) -> None:
        nn.init.uniform_(weight, -scale, scale, generator=generator)

    return init


@torch.no_grad()
def flax_init_(module: nn.Module, generator: torch.Generator, kernel_init=lecun_normal_) -> None:
    """Flax's defaults on every ``nn.Linear`` and ``nn.LayerNorm`` under
    ``module``: ``kernel_init`` on the weights, zero biases, unit scales."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            kernel_init(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class SinusoidalPositionEmbeddings(nn.Module):
    """Sinusoidal time embedding with a learnable frequency scale: sin then
    cos, exponent ``log(1e4) / (half - 1)``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.freq_scale = nn.Parameter(torch.ones(1))

    def forward(self, time: torch.Tensor) -> torch.Tensor:
        half_dim = self.dim // 2
        exponent = math.log(10000.0) / (half_dim - 1)
        freqs = torch.exp(
            torch.arange(half_dim, dtype=time.dtype, device=time.device) * -exponent
        )
        freqs = freqs * self.freq_scale
        args = time[:, None] * freqs[None, :]
        return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class AdaptiveLayerNorm(nn.Module):
    """LayerNorm without affine parameters, modulated by the conditioning:
    ``LN(x) * (1 + scale) + shift`` with ``[scale, shift] =
    adaLN_modulation(silu(cond))``."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.adaLN_modulation = nn.Linear(hidden_dim, 2 * hidden_dim)

    def forward(self, x: torch.Tensor, conditioning: torch.Tensor) -> torch.Tensor:
        scale, shift = self.adaLN_modulation(F.silu(conditioning)).chunk(2, dim=-1)
        normed = F.layer_norm(x, (self.hidden_dim,), eps=LN_EPS)
        return normed * (1.0 + scale) + shift


class MLP(nn.Module):
    """Linear layers of the given widths with an activation (and optionally a
    LayerNorm before it) after every layer but the last, unless
    ``activate_final``. Layers keep Flax's automatic names (``Dense_<i>``,
    ``LayerNorm_<i>``) so the bridge maps them; kernels init xavier-uniform
    (``reset_parameters``)."""

    def __init__(
        self,
        in_features: int,
        features: Sequence[int],
        activation: Callable[[torch.Tensor], torch.Tensor] = F.relu,
        use_layer_norm: bool = False,
        activate_final: bool = False,
    ):
        super().__init__()
        self.activation = activation
        self.num_layers = len(features)
        self.activate_final = activate_final
        self.use_layer_norm = use_layer_norm
        widths = [in_features, *features]
        for i in range(self.num_layers):
            setattr(self, f"Dense_{i}", nn.Linear(widths[i], widths[i + 1]))
            if use_layer_norm and (i < self.num_layers - 1 or activate_final):
                setattr(self, f"LayerNorm_{i}", nn.LayerNorm(widths[i + 1], eps=LN_EPS))

    def reset_parameters(self, generator: torch.Generator) -> None:
        flax_init_(self, generator, xavier_uniform_)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.num_layers - 1 or self.activate_final:
                if self.use_layer_norm:
                    x = getattr(self, f"LayerNorm_{i}")(x)
                x = self.activation(x)
        return x
