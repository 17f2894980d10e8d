"""Architecture configs ported so far (``stablelm-1.6b``)."""
from repro_torch.configs import stablelm_1_6b
from repro_torch.configs.base import (REGISTRY, ModelConfig, get_config,
                                      reduced)

__all__ = ["REGISTRY", "ModelConfig", "get_config", "reduced",
           "stablelm_1_6b"]
