"""State-observation agent, acting path.

Counterpart of ``active_inference_diffusion_tpu/agents/state_agent.py``
(``_act_impl`` :74-118, ``act`` :219-243). Training comes with a later port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .base import BaseAgent


class DiffusionStateAgent(BaseAgent):
    """Agent over raw state observations."""

    def act(
        self,
        observation: np.ndarray,
        generator: torch.Generator,
        deterministic: bool = False,
        collect: bool = True,
    ) -> np.ndarray:
        """Batched observations (N, obs_dim) -> actions (N, A) in [-1, 1].

        ``collect`` runs ``training_config.collect_diffusion_steps`` sweep
        steps (None = the full schedule); evaluation runs the full schedule.
        ``generator`` lives on the agent's device and feeds every draw."""
        obs = torch.as_tensor(observation, dtype=torch.float32, device=self.device)
        if obs.dim() == 1:
            obs = obs[None]
        num_steps = self.training_config.collect_diffusion_steps if collect else None
        z0, seed = self.core.draw_start(obs.shape[0], generator)
        action = self.act_from_start(obs, z0, seed, generator, deterministic, num_steps)
        return action.cpu().numpy()

    @torch.no_grad()
    def act_from_start(
        self,
        observation: torch.Tensor,
        z0: torch.Tensor,
        seed: torch.Tensor,
        generator: Optional[torch.Generator],
        deterministic: bool = False,
        num_steps: Optional[int] = None,
    ) -> torch.Tensor:
        """Everything of ``act`` after the start draw: belief sweep, policy,
        exploration noise (only when not deterministic), clip to [-1, 1]."""
        action, _ = self.core.act_from_start(
            observation, z0, seed, generator, deterministic, num_steps
        )
        if not deterministic:
            noise = torch.randn(action.shape, generator=generator, device=self.device)
            action = action + noise * self.exploration_noise
        # Always clip to the action space, as the JAX agent does.
        return torch.clamp(action, -1.0, 1.0)

    def act_warm(self, *args, **kwargs):
        raise NotImplementedError("warm-start acting (act_warm) is not ported yet")
