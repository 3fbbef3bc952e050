"""Latent dynamics f(s, a) -> s + delta(s, a), as a stacked ensemble.

Counterpart of ``active_inference_diffusion_tpu/models/dynamics.py`` and of
the ensemble the JAX core stacks over it with ``jax.vmap``
(``core/active_inference.py:220-228``, ``:292-303``). Every parameter has a
leading member axis; all members see the same input and run as one batched
product per layer. One member is the single residual MLP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import LN_EPS, lecun_normal_, small_uniform_init


class StackedLinear(nn.Module):
    """``members`` Linear layers: weight (members, out, in), bias (members,
    out); built with ``nn.Linear``'s default weights, uniform in
    +-1/sqrt(in), until ``reset_parameters`` or a load replaces them."""

    def __init__(self, members: int, in_features: int, out_features: int):
        super().__init__()
        bound = in_features**-0.5
        self.weight = nn.Parameter(
            torch.empty(members, out_features, in_features).uniform_(-bound, bound)
        )
        self.bias = nn.Parameter(torch.zeros(members, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (members, N, in)
        return torch.baddbmm(self.bias[:, None, :], x, self.weight.transpose(1, 2))


class StackedLayerNorm(nn.Module):
    """``members`` affine LayerNorms over the last axis, eps 1e-6."""

    def __init__(self, members: int, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(members, width))
        self.bias = nn.Parameter(torch.zeros(members, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        normed = F.layer_norm(x, (x.shape[-1],), eps=LN_EPS)
        return normed * self.weight[:, None, :] + self.bias[:, None, :]


class LatentDynamicsModel(nn.Module):
    """``members`` residual MLPs: ``num_layers`` blocks of Linear,
    LayerNorm and relu on [state, action], then a small-init head whose
    output is added to the state. Returns (members, N, state_dim)."""

    def __init__(self, state_dim: int, action_dim: int, hidden_dim: int = 256,
                 num_layers: int = 3, members: int = 1):
        super().__init__()
        self.members = members
        self.num_layers = num_layers
        widths = [state_dim + action_dim] + [hidden_dim] * num_layers
        for i in range(num_layers):
            setattr(self, f"fc{i}", StackedLinear(members, widths[i], widths[i + 1]))
            setattr(self, f"ln{i}", StackedLayerNorm(members, hidden_dim))
        self.out = StackedLinear(members, hidden_dim, state_dim)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Each member as Flax initialises it: lecun-normal kernels, zero
        biases, unit LayerNorm scales, the head uniform in +-1e-3 (so the
        residual dominates at init)."""
        for m in range(self.members):
            for i in range(self.num_layers):
                lecun_normal_(getattr(self, f"fc{i}").weight[m], generator)
            small_uniform_init(1e-3)(self.out.weight[m], generator)
        for module in self.modules():
            if isinstance(module, StackedLinear):
                module.bias.zero_()
            elif isinstance(module, StackedLayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()

    def forward(self, state: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        h = torch.cat([state, action], dim=-1).expand(self.members, -1, -1)
        for i in range(self.num_layers):
            h = F.relu(getattr(self, f"ln{i}")(getattr(self, f"fc{i}")(h)))
        return state + self.out(h)
