"""Model configuration (counterpart of ``repro.configs.base``).

Only the fields the ported paths read are kept; ``dtype`` (the compute
dtype) and ``param_dtype`` (the trainer's master weights) resolve to torch
dtypes; ``window`` is the sliding window of ``local`` blocks.
``mlstm_proj_factor`` and ``mlstm_chunk`` are the mLSTM block's inner
width factor and the chunk of its chunkwise kernel (xLSTM).
``input_mode`` is ``"tokens"``, ``"embeds"`` (precomputed frame
embeddings, the audio stub) or ``"tokens+vision"`` (``num_vision_tokens``
patch embeddings ahead of the token embeddings, the VLM stub);
``logits_softcap`` caps the loss's logits as ``tanh(l / c) * c``.
``moe`` (a :class:`MoEConfig`) makes every ``attn``/``local`` block's FFN
a mixture of experts (:mod:`repro_torch.models.moe`).
``reduced()`` derives the same tiny CPU-test variant as the JAX package
(an MoE one keeps 4 experts, top 2, ``d_ff_expert`` 64), and
``param_count()`` / ``active_param_count()`` are the reference's analytic
counts.  :class:`ShapeConfig`, :data:`SHAPES`, :data:`ARCH_IDS` and
:func:`applicable_shapes` are the launchers' shape cells
(:mod:`repro_torch.launch.common`).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Top-k routing over ``num_experts`` SwiGLU experts of width
    ``d_ff_expert``; each batch row gives an expert at most
    ``ceil(S * top_k / num_experts) * capacity_factor`` tokens of its S.
    ``norm_topk_prob`` renormalizes the k gate values to sum to 1."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    lb_loss_coef: float = 0.01
    z_loss_coef: float = 1e-3
    norm_topk_prob: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    block_pattern: Tuple[str, ...]
    num_groups: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    window: Optional[int] = None
    input_mode: str = "tokens"
    num_vision_tokens: int = 0
    mlstm_proj_factor: float = 2.0
    mlstm_chunk: int = 128
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    logits_softcap: Optional[float] = None
    source: str = ""

    @property
    def num_layers(self) -> int:
        return self.num_groups * len(self.block_pattern)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def parameter_dtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def supports_long_context(self) -> bool:
        """True if the decode state is O(1) or windowed (no full-attention
        KV cache)."""
        return all(b in ("rglru", "mlstm", "slstm", "local")
                   for b in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula (which counts the embedding in every input
        mode)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d  # embedding
        for block in self.block_pattern * self.num_groups:
            if block in ("attn", "local"):
                total += d * hd * (n_q + 2 * n_kv) + n_q * hd * d  # qkvo
                if self.moe is not None:
                    total += self.moe.num_experts * (
                        3 * d * self.moe.d_ff_expert) \
                        + d * self.moe.num_experts
                else:
                    total += 3 * d * self.d_ff  # gated MLP
                total += 2 * d  # norms
            elif block == "rglru":
                lru = d  # recurrence width
                total += d * 2 * lru + lru * 4 + lru * d
                total += 3 * d * self.d_ff + 2 * d
            elif block == "mlstm":
                inner = int(d * self.mlstm_proj_factor)
                total += d * 2 * inner + 3 * inner * inner // 1 + inner * d
                total += 2 * d
            elif block == "slstm":
                h = self.num_heads
                dh = d // h
                total += 4 * d * d + 4 * h * dh * dh + d * self.d_ff * 2 \
                    + 2 * d
        total += d * self.vocab_size  # LM head (untied)
        return total

    def active_param_count(self) -> int:
        """Parameters a token touches (MoE: only its top-k experts), the
        reference's count."""
        if self.moe is None:
            return self.param_count()
        per_expert = 3 * self.d_model * self.moe.d_ff_expert
        return self.param_count() - self.num_layers * per_expert * (
            self.moe.num_experts - self.moe.top_k)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = (
    "dbrx-132b",
    "qwen3-moe-30b-a3b",
    "musicgen-large",
    "mistral-nemo-12b",
    "deepseek-coder-33b",
    "deepseek-67b",
    "stablelm-1.6b",
    "xlstm-1.3b",
    "recurrentgemma-2b",
    "internvl2-2b",
)

REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    """Load an architecture config by id (imports its module on demand)."""
    if name not in REGISTRY:
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return REGISTRY[name]


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """Shape cells that run for this arch (long_500k needs sub-quadratic
    decode state)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        names.append("long_500k")
    return tuple(names)


def reduced(cfg: ModelConfig, *, seq_len: int = 64) -> ModelConfig:
    """Tiny same-family variant for CPU tests (same rules as ``repro``,
    including the window: at most half of ``seq_len``)."""
    if cfg.num_kv_heads == 1:
        kv = 1
    elif cfg.num_kv_heads == cfg.num_heads:
        kv = 4
    else:
        kv = 2
    kw = {}
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                        d_ff_expert=64)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_groups=max(1, min(2, cfg.num_groups)),
        d_model=64,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, seq_len // 2) if cfg.window else None,
        num_vision_tokens=8 if cfg.num_vision_tokens else 0,
        mlstm_chunk=16,
        dtype="float32",
        param_dtype="float32",
        **kw,
    )
