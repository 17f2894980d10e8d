"""Deprecation warnings that point at the caller's line (counterpart of
``repro._deprecation``).

A fixed ``stacklevel`` breaks whenever the number of frames between
``warnings.warn`` and user code varies (a shim reached through a
re-export, a dataclass ``__init__``).  :func:`warn_deprecated` walks the
stack instead and aims the warning at the first frame outside this package
and outside the stdlib machinery between a shim and its caller, so the
``DeprecationWarning``'s filename and line are the call that needs
migrating.
"""
from __future__ import annotations

import os
import sys
import warnings

__all__ = ["warn_deprecated"]

#: The repro_torch package itself plus the stdlib modules that sit between a
#: shim and its caller.
_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
_STDLIB_BASENAMES = frozenset({
    "dataclasses.py", "functools.py", "contextlib.py", "typing.py",
})


def _is_internal(filename: str) -> bool:
    if not filename or filename.startswith("<"):
        return True  # exec'd frames, e.g. dataclass-generated __init__
    path = os.path.abspath(filename)
    if os.path.basename(path) in _STDLIB_BASENAMES:
        return True
    return path.startswith(_PACKAGE_DIR + os.sep)


def caller_stacklevel() -> int:
    """Stacklevel (as :func:`warnings.warn` counts it from the caller of
    this helper's caller) of the first non-internal frame."""
    # Frame 0 is this function, frame 1 the warn_deprecated caller (the
    # shim); start scanning above the shim.
    level = 1
    frame = sys._getframe(1)
    while frame.f_back is not None:
        frame = frame.f_back
        level += 1
        if not _is_internal(frame.f_code.co_filename):
            return level
    return level


def warn_deprecated(message: str,
                    category: type = DeprecationWarning) -> None:
    """Emit ``message`` attributed to the nearest frame outside the
    repro_torch package."""
    warnings.warn(message, category, stacklevel=caller_stacklevel())
