"""PyTorch/CUDA port of ``repro``: the serving path on an NVIDIA Hopper card.

The package mirrors ``repro``'s layout and names so each module's
counterpart is easy to find.  It imports ``torch``, numpy and the standard
library only, never ``jax`` and nothing of ``repro``.

Entry points (:class:`repro_torch.serving.ServeEngine`, the step functions
in :mod:`repro_torch.serving.model`, :func:`repro_torch.models.lm.init`)
run on ``cuda`` unless the caller passes ``device="cpu"``.  On the card
every kernel of the path is one written by hand for ``sm_90a``
(:mod:`repro_torch.kernels`); on the CPU each wrapper runs its plain
PyTorch version, which is what the CPU tests compare with the JAX package.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
