"""InternVL2-2B: InternViT vision frontend (STUB) + InternLM2 LM backbone.

The caller passes precomputed patch embeddings (B, 256, d_model) as
``batch["vision_embeds"]``; they are concatenated ahead of the token
embeddings.  [arXiv:2404.16821; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    block_pattern=("attn",),
    num_groups=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    input_mode="tokens+vision",
    num_vision_tokens=256,
    rope_theta=1000000.0,
    source="arXiv:2404.16821",
))
