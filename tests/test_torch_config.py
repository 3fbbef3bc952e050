"""The port's own copy of the configuration: the same dataclasses, fields,
defaults, checks and YAML loader as the JAX package's, and the humanoid
preset built in code equal to the file it mirrors."""

from pathlib import Path

import pytest

from active_inference_diffusion_tpu.configs import config as jax_config
from active_inference_diffusion_torch.configs import config as port_config
from active_inference_diffusion_torch.configs.presets import humanoid_state

REPO = Path(__file__).resolve().parents[1]
CLASSES = (
    "ActiveInferenceConfig", "DiffusionConfig", "BeliefDynamicsConfig", "SemanticsConfig",
    "TpuConfig", "TrainingConfig", "PixelObservationConfig",
)


@pytest.mark.parametrize("name", CLASSES)
def test_config_copy_matches_jax_fields_and_defaults(name):
    ours, theirs = getattr(port_config, name)(), getattr(jax_config, name)()
    assert port_config.config_to_dict(ours) == jax_config.config_to_dict(theirs)


def test_config_copy_runs_the_same_checks():
    with pytest.raises(ValueError, match="prediction_type"):
        port_config.DiffusionConfig(prediction_type="eps")
    with pytest.raises(ValueError, match="semantics mode"):
        port_config.SemanticsConfig(mode="other")
    cfg = port_config.ActiveInferenceConfig(expected_free_energy_horizon=7)
    assert cfg.efe_horizon == 7  # alias folded as in the JAX package
    with pytest.raises(KeyError, match="Unknown config field"):
        port_config._update_dataclass(port_config.TpuConfig(), {"kernel": "v3"})


@pytest.mark.parametrize(
    "path", ["humanoid_state.yaml", "halfcheetah_state.yaml", "hopper_pixel.yaml"]
)
def test_load_yaml_config_matches_jax(path):
    file = str(REPO / "examples" / "configs" / path)
    ours, theirs = port_config.load_yaml_config(file), jax_config.load_yaml_config(file)
    for a, b in zip(ours, theirs):
        assert port_config.config_to_dict(a) == jax_config.config_to_dict(b)


def test_humanoid_preset_equals_its_yaml():
    cfg, training = humanoid_state()
    file_cfg, file_training, pixel = port_config.load_yaml_config(
        str(REPO / "examples" / "configs" / "humanoid_state.yaml")
    )
    assert pixel is None
    assert port_config.config_to_dict(cfg) == port_config.config_to_dict(file_cfg)
    assert port_config.config_to_dict(training) == port_config.config_to_dict(file_training)
    assert (cfg.tpu.compute_dtype, cfg.latent_dim, cfg.hidden_dim) == ("bfloat16", 64, 256)
    assert cfg.belief_dynamics.use_belief_dynamics and training.collect_diffusion_steps == 25
