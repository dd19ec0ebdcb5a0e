"""Warn-once machinery for the facade's deprecation shims.

The old kwarg-threaded entry helpers (``serving.serve_frames``, the legacy
kwargs of ``core.snn_train.make_train_step`` and its siblings) keep working
but emit exactly one ``DeprecationWarning`` per process per shim.  Tests
reset the registry with ``reset_deprecation_warnings()`` to check the
once-only contract.
"""
from __future__ import annotations

import threading
import warnings
from typing import Set

__all__ = ["warn_deprecated_once", "reset_deprecation_warnings"]

_WARNED: Set[str] = set()
_LOCK = threading.Lock()


def warn_deprecated_once(key: str, message: str) -> None:
    """Emit ``DeprecationWarning(message)`` the first time ``key`` is seen."""
    with _LOCK:
        if key in _WARNED:
            return
        _WARNED.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)


def reset_deprecation_warnings() -> None:
    """Forget which shims already warned (test hook)."""
    with _LOCK:
        _WARNED.clear()
