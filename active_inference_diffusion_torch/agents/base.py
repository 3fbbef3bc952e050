"""Host-side agent shell.

Counterpart of ``active_inference_diffusion_tpu/agents/base.py:145-176``
(``BaseAgent``) without the optimizers and the train state, which come with
the training slice.
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import torch

from ..bridge import load_jax_params
from ..configs.config import ActiveInferenceConfig, TrainingConfig
from ..core.active_inference import DiffusionActiveInference


class BaseAgent:
    """Holds the configs, the model container and the exploration noise scale.
    ``device`` None means CUDA, and raises where there is none."""

    def __init__(
        self,
        observation_dim: int,
        action_dim: int,
        config: ActiveInferenceConfig,
        training_config: TrainingConfig,
        device: Optional[torch.device] = None,
    ):
        self.config = config
        self.training_config = training_config
        self.observation_dim = observation_dim
        self.action_dim = action_dim
        self.core = DiffusionActiveInference(
            observation_dim=observation_dim,
            action_dim=action_dim,
            latent_dim=config.latent_dim,
            config=config,
            device=device,
        )
        self.device = self.core.device
        self.exploration_noise = training_config.exploration_noise

    def load_jax_params(self, params: Mapping) -> Tuple[str, ...]:
        """Load the acting parameters of the JAX agent (``params`` as a nested
        dict of numpy arrays). Returns the groups it leaves for later ports."""
        return load_jax_params(self.core, params)
