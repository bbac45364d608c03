"""Architecture configs: the port's copy of the JAX package's
``repro.configs`` (data only)."""
from repro_torch.configs.base import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                      MLAConfig, MoEConfig, ModelConfig,
                                      SSMConfig, XLSTMConfig, all_configs,
                                      get_config, reduced)

__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "MLAConfig",
           "MoEConfig", "ModelConfig", "SSMConfig", "XLSTMConfig",
           "all_configs", "get_config", "reduced"]
