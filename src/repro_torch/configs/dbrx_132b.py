"""DBRX-132B: fine-grained MoE, 16 experts top-4.

[hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="dbrx-132b",
    family="moe",
    block_pattern=("attn",),
    num_groups=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=10752),
    rope_theta=500000.0,
    source="hf:databricks/dbrx-base",
))
