"""The CUDA denoise-sweep kernel against its plain PyTorch version, on the card.

Every test here needs an NVIDIA GPU, is marked ``cuda`` and skips without
one. The file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernel_cuda.py

(``--noconftest`` skips tests/conftest.py, which sets up JAX.) The kernel
and the plain version are both float32 and differ in summation order:
rtol 1e-4 / atol 1e-5 at these small widths.
"""

import numpy as np
import pytest
import torch

from active_inference_diffusion_torch import (
    ActiveInferenceConfig,
    DiffusionConfig,
    DiffusionStateAgent,
    TrainingConfig,
)
from active_inference_diffusion_torch.core.schedules import make_schedule
from active_inference_diffusion_torch.models.score_network import LatentScoreNetwork
from active_inference_diffusion_torch.ops.denoise import (
    denoise_sweep_reference,
    fused_denoise_sweep,
    packed_trunk_weights,
)

pytestmark = pytest.mark.cuda

OBS_DIM = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def randomize(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            fan_in = p.shape[-1] if p.dim() == 2 else p.shape[0]
            p.copy_(torch.randn(p.shape, generator=gen) / fan_in**0.5)


def sweep_args(device, batch, latent, hidden, layers, steps, seed=0):
    net = LatentScoreNetwork(latent, OBS_DIM, hidden_dim=hidden, num_layers=layers).to(device)
    randomize(net, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    z0 = torch.randn((batch, latent), generator=gen, device=device)
    obs = torch.randn((batch, OBS_DIM), generator=gen, device=device)
    with torch.no_grad():
        obs_emb = net.obs_embedding(obs).contiguous()
        t = torch.arange(steps - 1, -1, -1, device=device, dtype=torch.float32)
        t_embs = net.time_embedding(t, continuous=False).contiguous()
    seed_t = torch.tensor(99, dtype=torch.int64, device=device)
    return (make_schedule(steps, device=device), packed_trunk_weights(net), z0, obs_emb,
            t_embs, seed_t, steps, layers)


# (batch, latent, hidden, layers): the parity tests' widths, a ragged batch,
# and a latent that is not a multiple of 4 (padded rows, matmul tail).
@pytest.mark.parametrize("shape", [(8, 8, 32, 2), (37, 8, 32, 2), (20, 50, 64, 1)])
@pytest.mark.parametrize("deterministic", [True, False])
def test_kernel_matches_plain_version(cuda, shape, deterministic):
    args = sweep_args(cuda, *shape, steps=5)
    before = fused_denoise_sweep.launches
    got = fused_denoise_sweep(*args, deterministic=deterministic)
    torch.cuda.synchronize()
    assert fused_denoise_sweep.launches == before + 1
    want = denoise_sweep_reference(*args, deterministic=deterministic)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=1e-4, atol=1e-5)


def test_agent_act_launches_the_kernel_once_per_call(cuda):
    cfg = ActiveInferenceConfig(
        observation_dim=OBS_DIM, action_dim=2, latent_dim=8, hidden_dim=32,
        score_num_layers=2, diffusion=DiffusionConfig(num_diffusion_steps=5),
    )
    agent = DiffusionStateAgent(OBS_DIM, 2, cfg, TrainingConfig(), device=cuda)
    randomize(agent.core, 1)
    gen = torch.Generator(device=cuda).manual_seed(0)
    obs = np.random.default_rng(0).standard_normal((6, OBS_DIM)).astype(np.float32)
    before = fused_denoise_sweep.launches
    for deterministic in (True, False, False):
        actions = agent.act(obs, gen, deterministic=deterministic)
        assert actions.shape == (6, 2) and np.isfinite(actions).all()
        assert np.abs(actions).max() <= 1.0
    assert fused_denoise_sweep.launches == before + 3


def test_kernel_raises_beyond_its_shared_memory_plan(cuda):
    args = list(sweep_args(cuda, 4, 128, 512, 1, steps=2))
    with pytest.raises(ValueError, match="shared memory"):
        fused_denoise_sweep(*args, deterministic=True)


def test_kernel_rejects_what_it_does_not_take(cuda):
    args = list(sweep_args(cuda, 8, 8, 32, 2, steps=5))
    strided = list(args)
    strided[2] = torch.randn(8, 16, device=cuda)[:, ::2]  # non-contiguous z0
    with pytest.raises(ValueError, match="contiguous"):
        fused_denoise_sweep(*strided, deterministic=True)
    cpu_seed = list(args)
    cpu_seed[5] = torch.tensor(0, dtype=torch.int64)
    with pytest.raises(TypeError, match="seed"):
        fused_denoise_sweep(*cpu_seed, deterministic=True)
