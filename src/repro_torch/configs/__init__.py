"""Architecture configs ported so far: the dense ``attn`` family
(``stablelm-1.6b``, ``mistral-nemo-12b``, ``deepseek-67b``,
``deepseek-coder-33b``), its input modes (``musicgen-large`` on embeds,
``internvl2-2b`` on tokens + vision), ``recurrentgemma-2b`` and
``xlstm-1.3b``.  The MoE configs wait for the MoE slice."""
from repro_torch.configs import (deepseek_67b, deepseek_coder_33b,
                                 internvl2_2b, mistral_nemo_12b,
                                 musicgen_large, recurrentgemma_2b,
                                 stablelm_1_6b, xlstm_1_3b)
from repro_torch.configs.base import (REGISTRY, ModelConfig, get_config,
                                      reduced)

__all__ = ["REGISTRY", "ModelConfig", "deepseek_67b", "deepseek_coder_33b",
           "get_config", "internvl2_2b", "mistral_nemo_12b", "musicgen_large",
           "recurrentgemma_2b", "reduced", "stablelm_1_6b", "xlstm_1_3b"]
