"""Qwen3-MoE-30B-A3B: 128 experts top-8, fine-grained experts.

[hf:Qwen/Qwen3-30B-A3B; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    block_pattern=("attn",),
    num_groups=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768,
                  norm_topk_prob=True),
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
))
