"""Lambda-returns over the batch axis, vectorised.

Counterpart of ``active_inference_diffusion_tpu/core/returns.py``: like the
reference, the batch index is the trajectory axis (replay transitions are
chained as if consecutive). See the JAX docstring for the exact rule.
"""

from __future__ import annotations

import torch


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """y[i] = x[i + k], zero-padded at the end."""
    if k == 0:
        return x
    if k >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([x[k:], torch.zeros(k, dtype=x.dtype, device=x.device)])


def compute_lambda_returns(
    rewards: torch.Tensor,
    values: torch.Tensor,
    next_values: torch.Tensor,
    dones: torch.Tensor,
    discount: float = 0.99,
    lambda_: float = 0.95,
    n_steps: int = 5,
    exclude_immediate_rewards: bool = False,
) -> torch.Tensor:
    """Lambda-weighted average of the valid 1..n-step returns of each index
    (n <= min(n_steps, B - idx - 1)), each bootstrapped with next_values
    where its end lies in the batch and no done cut it; an index with no
    valid n falls back to the one-step TD target."""
    del values  # unused, as in the reference
    b = rewards.shape[0]
    dtype, device = rewards.dtype, rewards.device
    dones_f = dones.to(dtype)
    f = discount * (1.0 - dones_f)

    idx = torch.arange(b, device=device)
    m = torch.clamp(b - idx - 1, max=n_steps)

    returns = []
    running_sum = torch.zeros_like(rewards)
    running_disc = torch.ones_like(rewards)
    for n in range(1, n_steps + 1):
        k = n - 1
        if not (exclude_immediate_rewards and k == 0):
            running_sum = running_sum + running_disc * _shift(rewards, k)
        running_disc = running_disc * _shift(f, k)
        in_range = idx + n < b
        not_done = _shift(dones_f, n - 1) == 0.0
        bootstrap = torch.where(in_range & not_done, running_disc * _shift(next_values, n), 0.0)
        returns.append(running_sum + bootstrap)
    rets = torch.stack(returns, dim=1)

    i = torch.arange(n_steps, device=device)[None, :]
    powers = lambda_ ** i.to(dtype)
    weights = torch.where(i == m[:, None] - 1, powers, (1.0 - lambda_) * powers)
    weights = weights * (i < m[:, None]).to(dtype)
    weighted = torch.sum(weights * rets, dim=1) / (torch.sum(weights, dim=1) + 1e-8)

    fallback = f * next_values if exclude_immediate_rewards else rewards + f * next_values
    return torch.where(m > 0, weighted, fallback)
