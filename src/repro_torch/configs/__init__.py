from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                     reduce_config)
from repro_torch.configs.registry import ARCH_IDS, get_config, get_smoke_config

__all__ = ["MLAConfig", "MoEConfig", "ModelConfig", "reduce_config",
           "ARCH_IDS", "get_config", "get_smoke_config"]
