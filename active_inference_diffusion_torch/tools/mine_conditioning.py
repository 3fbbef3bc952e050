"""How far the MINE update's gradient in float32 is from float64, on the CPU.

    python -m active_inference_diffusion_torch.tools.mine_conditioning

Run from the repository root. Builds the flagship agent (HalfCheetah-v4,
latent 32, hidden 128) with the Flax initialisers from a seed, draws one
MINE update's inputs (B=256 transitions, latents N(0, s^2) for a few scales
s), and takes the estimator's gradient of -MI twice: in float32 and with
every module and input in float64. Prints one JSON line per scale: the
relative L2 distance of the two gradients and of the MI values. It bounds
how closely two float32 runs that sum in another order (the card and the
CPU) can agree on this gradient. No card needed.
"""

from __future__ import annotations

import copy
import json

import torch

from ..agents.state_agent import MINE_SAMPLES, DiffusionStateAgent
from ..configs.config import ActiveInferenceConfig, DiffusionConfig, TrainingConfig
from ..core.epistemic import draw_mine, estimate_epistemic_value


def mine_gradient(core, latents, actions, draws, dtype):
    est = core.epistemic_estimator
    est.zero_grad()
    with torch.no_grad():
        mean, logvar = core.predict_next_latent(latents.to(dtype), actions.to(dtype))
    draws = draws._replace(noise=draws.noise.to(dtype), directions=draws.directions.to(dtype))
    result = estimate_epistemic_value(est, core.decode_observation, mean, logvar, draws,
                                      torch.zeros((), dtype=dtype))
    (-result.mi_lower_bound).backward()
    grad = torch.cat([p.grad.flatten().double() for p in est.parameters() if p.grad is not None])
    return grad, float(result.mi_lower_bound.detach())


def main() -> int:
    cfg = ActiveInferenceConfig(latent_dim=32, hidden_dim=128,
                                diffusion=DiffusionConfig(num_diffusion_steps=25))
    agent = DiffusionStateAgent(17, 6, cfg, TrainingConfig(), device="cpu")
    agent.core.init_params(torch.Generator().manual_seed(300))
    core64 = copy.deepcopy(agent.core).double()
    for scale in (1.0, 3.0, 10.0):
        g = torch.Generator().manual_seed(1)
        latents = scale * torch.randn(256, 32, generator=g)
        actions = torch.tanh(torch.randn(256, 6, generator=g))
        draws = draw_mine(256, 32, MINE_SAMPLES, 4, g, "cpu")
        g32, mi32 = mine_gradient(agent.core, latents, actions, draws, torch.float32)
        g64, mi64 = mine_gradient(core64, latents, actions, draws, torch.float64)
        print(json.dumps({"latent_scale": scale, "mi_f32": mi32, "mi_f64": mi64,
                          "grad_rel_l2_f32_vs_f64": float((g32 - g64).norm() / g64.norm())}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
