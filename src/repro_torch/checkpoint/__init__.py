"""Checkpoints of the port (``repro.checkpoint``): the manager."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
