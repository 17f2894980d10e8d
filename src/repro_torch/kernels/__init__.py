"""Kernels written by hand for Hopper, with their plain PyTorch versions.

``ops`` holds the public entry points; ``ref`` the plain versions; one
module per kernel (``sma_gemm``, ``norm_gemm``, ``decode_attention``,
``flash_attention``) holds its wrappers and launch counters; ``autograd``
the ``torch.autograd.Function`` of each kernel the trainer differentiates;
``_build`` compiles ``csrc/*.cu``.  No module builds or loads a kernel
when it is imported.
"""
