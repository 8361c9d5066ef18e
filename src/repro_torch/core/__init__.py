from repro_torch.core.cache import TwoLevelLRU
from repro_torch.core.coordinator import (Policy, baseline, expertflow,
                                          pregate_fixed, promoe_like)
from repro_torch.core.predictor import ForestPredictor, PreGate
from repro_torch.core.step_size import (StepSizeConfig, StepSizeController,
                                        initial_step_size, token_diversity)
from repro_torch.core.trace import FeatureSpec, Sample, TraceLog

__all__ = [
    "TwoLevelLRU", "Policy", "baseline", "expertflow", "pregate_fixed",
    "promoe_like", "ForestPredictor", "PreGate", "StepSizeConfig",
    "StepSizeController", "initial_step_size", "token_diversity",
    "FeatureSpec", "Sample", "TraceLog",
]
