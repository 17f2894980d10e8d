"""Architecture configs ported so far (``stablelm-1.6b``,
``recurrentgemma-2b``, ``xlstm-1.3b``)."""
from repro_torch.configs import recurrentgemma_2b, stablelm_1_6b, xlstm_1_3b
from repro_torch.configs.base import (REGISTRY, ModelConfig, get_config,
                                      reduced)

__all__ = ["REGISTRY", "ModelConfig", "get_config", "recurrentgemma_2b",
           "reduced", "stablelm_1_6b", "xlstm_1_3b"]
