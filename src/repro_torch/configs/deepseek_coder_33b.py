"""DeepSeek-Coder-33B: llama-arch dense GQA transformer.

[arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    block_pattern=("attn",),
    num_groups=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100000.0,
    source="arXiv:2401.14196",
))
