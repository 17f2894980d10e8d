"""Mistral-Nemo-12B: dense GQA transformer, 128k-context family.

[hf:mistralai/Mistral-Nemo-Base-2407; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    block_pattern=("attn",),
    num_groups=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1000000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
))
