"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 1 attn : 2 recurrent.

26 blocks as 2 groups x 13 (9 recurrent + 4 local-attention per group =
18 + 8 overall, the published ratio).  Window 2048, MQA (kv=1).
[arXiv:2402.19427; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    block_pattern=("rglru", "rglru", "local") * 4 + ("rglru",),
    num_groups=2,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    window=2048,
    source="arXiv:2402.19427",
))
