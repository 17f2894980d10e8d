"""MusicGen-large: decoder-only transformer over EnCodec audio tokens.

The EnCodec frontend is a stub: the caller passes precomputed frame
embeddings (B, S, d_model) as ``batch["embeds"]``; the backbone is standard
MHA.
[arXiv:2306.05284; hf]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    block_pattern=("attn",),
    num_groups=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    input_mode="embeds",
    source="arXiv:2306.05284",
))
