"""Loss-aware importance sampling of diffusion time.

Counterpart of ``active_inference_diffusion_tpu/core/time_sampler.py``: 100
time bins with softmax weights; a time is a bin drawn from the softmax and
a uniform jitter within it. The bin update takes one EMA step per touched
bin toward the mean loss of its samples.
"""

from __future__ import annotations

from typing import Tuple

import torch

NUM_BINS = 100


def init_time_importance(device=None) -> torch.Tensor:
    """Uniform initial weights over the 100 bins."""
    return torch.ones(NUM_BINS, device=device)


def draw_time(
    weights: torch.Tensor, batch_size: int, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The draws of ``importance_sample_time``: bins (B,) int64 from
    softmax(weights) and a jitter (B,) uniform in [0, 1)."""
    bins = torch.multinomial(
        torch.softmax(weights, dim=0), batch_size, replacement=True, generator=generator
    )
    jitter = torch.rand(batch_size, generator=generator, device=weights.device)
    return bins, jitter


def importance_sample_time(bins: torch.Tensor, jitter: torch.Tensor) -> torch.Tensor:
    """Continuous t in [0, 1) from a bin and a jitter within it."""
    return (bins.to(jitter.dtype) + jitter) / float(NUM_BINS)


def update_time_importance(
    weights: torch.Tensor, t: torch.Tensor, losses: torch.Tensor, ema: float = 0.99
) -> torch.Tensor:
    """Each bin touched by ``t`` takes one EMA step toward the mean of its
    samples' losses; the others keep their weight. The per-bin sums are a
    one-hot product reduced in a fixed order, not ``index_add_``, whose
    atomics on the card sum in no fixed order: a replayed update and a
    resumed run then reproduce the eager one bit for bit."""
    bins = torch.clamp((t * (NUM_BINS - 1)).to(torch.int64), 0, NUM_BINS - 1)
    onehot = (bins[:, None] == torch.arange(NUM_BINS, device=bins.device)).to(losses.dtype)
    sums = (onehot * losses[:, None]).sum(dim=0)
    counts = onehot.sum(dim=0)
    touched = counts > 0
    mean_loss = torch.where(touched, sums / torch.clamp(counts, min=1.0), 0.0)
    return torch.where(touched, ema * weights + (1.0 - ema) * mean_loss, weights)
