from .config import (
    ActiveInferenceConfig,
    BeliefDynamicsConfig,
    DiffusionConfig,
    PixelObservationConfig,
    SemanticsConfig,
    TpuConfig,
    TrainingConfig,
    config_to_dict,
    load_yaml_config,
)
