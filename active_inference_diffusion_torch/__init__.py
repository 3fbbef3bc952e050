"""active-inference-diffusion-torch: the PyTorch/CUDA port of
``active_inference_diffusion_tpu``.

The JAX package is the reference; each module here keeps its counterpart's
name and public tensor layouts, and is held against it by parity tests
(``tests/test_torch_*.py``). The TPU's Pallas kernel becomes a CUDA C++
kernel for Hopper (``csrc/denoise_sweep.cu``), built with ``nvcc`` on first
use. Configuration dataclasses are shared with the JAX package, whose
``configs`` module imports no JAX.

This package imports ``torch`` and ``numpy`` and never ``jax``.
"""

__version__ = "0.1.0"

from active_inference_diffusion_tpu.configs.config import (
    ActiveInferenceConfig,
    DiffusionConfig,
    TrainingConfig,
)

from .agents.state_agent import DiffusionStateAgent

__all__ = [
    "ActiveInferenceConfig",
    "DiffusionConfig",
    "DiffusionStateAgent",
    "TrainingConfig",
]
