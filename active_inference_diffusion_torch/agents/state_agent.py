"""State-observation agent, acting path.

Counterpart of ``active_inference_diffusion_tpu/agents/state_agent.py``
(``_act_impl`` :74-118, ``_act_warm_impl`` / ``act_warm`` :141-217, ``act``
:219-243). Training comes with a later port.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.active_inference import ActStart
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
        start = self.core.draw_start(obs.shape[0], generator)
        action, _ = self.act_from_start(obs, start, generator, deterministic, num_steps)
        return action.cpu().numpy()

    def act_warm(
        self,
        observation: np.ndarray,
        generator: torch.Generator,
        prev_latents: torch.Tensor,
        reset_mask: np.ndarray,
        deterministic: bool = False,
        num_steps: Optional[int] = None,
    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Warm-start acting: each row's sweep starts from its previous
        belief (``prev_latents`` (N, D)), forward-noised to the truncation
        timestep, instead of pure noise; rows where ``reset_mask`` (N,) is
        True start from fresh N(0, I) latents. ``num_steps`` defaults to
        ``training_config.collect_diffusion_steps``. Returns the actions (N,
        A) and the belief latents (N, D) on the agent's device, to pass back
        as the next call's ``prev_latents``."""
        obs = torch.as_tensor(observation, dtype=torch.float32, device=self.device)
        mask = torch.as_tensor(np.asarray(reset_mask, bool), device=self.device)
        fresh = torch.randn(prev_latents.shape, generator=generator, device=self.device)
        start = self.core.draw_start(obs.shape[0], generator)
        if num_steps is None:
            num_steps = self.training_config.collect_diffusion_steps
        action, latent = self.act_warm_from_start(
            obs, prev_latents, mask, fresh, start, generator, deterministic, num_steps
        )
        return action.cpu().numpy(), latent

    @torch.no_grad()
    def act_warm_from_start(
        self,
        observation: torch.Tensor,
        prev_latents: torch.Tensor,
        reset_mask: torch.Tensor,
        fresh: torch.Tensor,
        start: ActStart,
        generator: Optional[torch.Generator],
        deterministic: bool = False,
        num_steps: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything of ``act_warm`` after its draws: ``fresh`` replaces
        the reset rows of ``prev_latents``, then ``act_from_start`` from
        there."""
        z_prev = torch.where(reset_mask[:, None], fresh, prev_latents.to(self.device))
        return self.act_from_start(
            observation, start, generator, deterministic, num_steps, z_init=z_prev
        )

    @torch.no_grad()
    def act_from_start(
        self,
        observation: torch.Tensor,
        start: ActStart,
        generator: Optional[torch.Generator],
        deterministic: bool = False,
        num_steps: Optional[int] = None,
        z_init: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Everything of ``act`` after the start draws: the belief (sweep,
        from ``z_init`` when given, and refinement), the policy, exploration
        noise (only when not deterministic) and the clip to [-1, 1]. Returns
        (actions, belief latents)."""
        latent = self.core.belief_latent(observation, start, num_steps, z_init)
        action, _ = self.core.policy_action(latent, generator, deterministic)
        if not deterministic:
            noise = torch.randn(action.shape, generator=generator, device=self.device)
            action = action + noise * self.exploration_noise
        # Always clip to the action space, as the JAX agent does.
        return torch.clamp(action, -1.0, 1.0), latent
