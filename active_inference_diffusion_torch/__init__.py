"""active-inference-diffusion-torch: the PyTorch/CUDA port of
``active_inference_diffusion_tpu``.

The JAX package is the reference; each module here keeps its counterpart's
name and public tensor layouts, and is held against it by parity tests
(``tests/test_torch_*.py``). Each TPU Pallas kernel becomes a CUDA C++
kernel for Hopper (``csrc/``), built with ``nvcc`` on first use. The
configuration dataclasses are the port's own copy (``configs/config.py``).
Entry points run on the CUDA device unless the caller passes another.

This package imports ``torch`` and ``numpy``, never ``jax`` and nothing of
``active_inference_diffusion_tpu``.
"""

__version__ = "0.1.0"

from .agents.state_agent import DiffusionStateAgent
from .configs.config import (
    ActiveInferenceConfig,
    DiffusionConfig,
    TrainingConfig,
    load_yaml_config,
)

__all__ = [
    "ActiveInferenceConfig",
    "DiffusionConfig",
    "DiffusionStateAgent",
    "TrainingConfig",
    "load_yaml_config",
]
