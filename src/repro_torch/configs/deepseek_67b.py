"""DeepSeek-67B: llama-arch dense GQA transformer (95 layers).

[arXiv:2401.02954; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-67b",
    family="dense",
    block_pattern=("attn",),
    num_groups=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
    source="arXiv:2401.02954",
))
