"""Every architecture config of the reference: the dense ``attn`` family
(``stablelm-1.6b``, ``mistral-nemo-12b``, ``deepseek-67b``,
``deepseek-coder-33b``), its input modes (``musicgen-large`` on embeds,
``internvl2-2b`` on tokens + vision), ``recurrentgemma-2b``,
``xlstm-1.3b``, and the MoE ones (``qwen3-moe-30b-a3b``,
``dbrx-132b``)."""
from repro_torch.configs import (dbrx_132b, deepseek_67b, deepseek_coder_33b,
                                 internvl2_2b, mistral_nemo_12b,
                                 musicgen_large, qwen3_moe_30b_a3b,
                                 recurrentgemma_2b, stablelm_1_6b,
                                 xlstm_1_3b)
from repro_torch.configs.base import (ARCH_IDS, REGISTRY, SHAPES,
                                      ModelConfig, MoEConfig, ShapeConfig,
                                      applicable_shapes, get_config, reduced)

__all__ = ["ARCH_IDS", "REGISTRY", "SHAPES", "ModelConfig", "MoEConfig",
           "ShapeConfig", "applicable_shapes", "dbrx_132b",
           "deepseek_67b", "deepseek_coder_33b", "get_config",
           "internvl2_2b", "mistral_nemo_12b", "musicgen_large",
           "qwen3_moe_30b_a3b", "recurrentgemma_2b", "reduced",
           "stablelm_1_6b", "xlstm_1_3b"]
