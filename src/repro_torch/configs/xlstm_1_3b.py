"""xLSTM-1.3B: 7:1 mLSTM:sLSTM block ratio (48 layers, 6 groups of 8).

mLSTM blocks carry the matrix memory (chunkwise-parallel in prefill through
the ``mlstm_chunkwise`` kernel); sLSTM blocks are sequential scalar
memories.  As configured here (d_model 2048, 4 heads, mLSTM inner width
4096, so head dim 1024) the model has 3.503 B parameters, despite its
name.  [arXiv:2405.04517]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    block_pattern=("mlstm",) * 7 + ("slstm",),
    num_groups=6,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    mlstm_proj_factor=2.0,
    mlstm_chunk=128,
    source="arXiv:2405.04517",
))
