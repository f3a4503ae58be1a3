from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    all_configs,
    get_config,
    get_smoke_config,
)

__all__ = [
    "ARCH_IDS",
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "all_configs",
    "get_config",
    "get_smoke_config",
]
