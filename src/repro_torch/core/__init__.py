"""Core SMA definitions shared by the kernels (epilogues)."""
from repro_torch.core.sma import EPILOGUE_CODES, EPILOGUES

__all__ = ["EPILOGUE_CODES", "EPILOGUES"]
