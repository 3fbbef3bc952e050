"""Configurations built in code, each mirroring a preset file of the repo.

``humanoid_state`` returns what ``load_yaml_config`` gives for
``examples/configs/humanoid_state.yaml``, without PyYAML (a GPU host may
lack it); a test holds the two equal. The environment's
dimensions are not in the file: the agent takes them from the environment
(Humanoid-v4, ``active_inference_diffusion_tpu/envs/mujoco_tasks.py:146``).
"""

from __future__ import annotations

from typing import Tuple

from .config import (
    ActiveInferenceConfig,
    BeliefDynamicsConfig,
    DiffusionConfig,
    SemanticsConfig,
    TpuConfig,
    TrainingConfig,
)

# Humanoid-v4: observation and action dimensions.
HUMANOID_OBS_DIM, HUMANOID_ACT_DIM = 376, 17


def humanoid_state() -> Tuple[ActiveInferenceConfig, TrainingConfig]:
    """examples/configs/humanoid_state.yaml: latent 64, hidden 256, 6 DiT
    blocks, K=50 cosine, bfloat16 sweep weights, one Fokker-Planck
    refinement step at act time, 25 collect steps, 8 parallel envs."""
    config = ActiveInferenceConfig(
        semantics=SemanticsConfig(score_target_convention="reference"),
        env_name="Humanoid-v4",
        latent_dim=64,
        hidden_dim=256,
        learning_rate=1.0e-4,
        batch_size=256,
        efe_horizon=10,
        num_efe_trajectories=10,
        epistemic_weight=0.1,
        belief_dynamics=BeliefDynamicsConfig(
            use_belief_dynamics=True, use_full_covariance=False
        ),
        diffusion=DiffusionConfig(num_diffusion_steps=50, beta_schedule="cosine"),
        tpu=TpuConfig(
            remat_score_network=True, use_pallas_denoiser=True, compute_dtype="bfloat16"
        ),
    )
    training = TrainingConfig(
        total_timesteps=2_000_000,
        buffer_size=200_000,
        learning_starts=10_000,
        num_parallel_envs=8,
        collect_diffusion_steps=25,
    )
    return config, training
