"""Named epilogues an SMA GEMM can fuse (``repro.core.sma.EPILOGUES``).

The CUDA kernels apply the same functions to their f32 accumulators; the
codes they take are the positions in :data:`EPILOGUE_CODES`.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

EPILOGUES: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "none": lambda x: x,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": lambda x: x * torch.sigmoid(x),
    "tanh": torch.tanh,
}

#: epilogue name -> integer code understood by ``csrc/gemm_tile.cuh``.
EPILOGUE_CODES: Dict[str, int] = {name: i for i, name in enumerate(EPILOGUES)}
