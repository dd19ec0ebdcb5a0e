"""Structured stderr logging for the launchers, the examples and the engine
(the reference's ``repro.obs.log``).

Every subsystem gets a child of the ``repro_torch`` root logger
(``get_logger("serve")`` -> ``repro_torch.serve``), all output goes to
stderr in one fixed single-line format, and the library default is quiet
(WARNING), so importing the port, and the test run, prints nothing.  Entry
points opt into chatter with ``configure_logging("info")`` (the launchers'
``--log-level`` flag).

Per-subsystem levels: ``configure_logging("info", {"serve": "debug"})``
sets the root to INFO and ``repro_torch.serve`` to DEBUG; the standard
logging hierarchy does the rest.
"""
from __future__ import annotations

import logging
import sys
from typing import Dict, Optional

__all__ = ["get_logger", "configure_logging", "LOG_LEVELS"]

LOG_LEVELS = ("debug", "info", "warning", "error")

_ROOT = "repro_torch"
_FORMAT = "%(asctime)s %(name)s %(levelname).1s %(message)s"
_DATEFMT = "%H:%M:%S"


def _root() -> logging.Logger:
    return logging.getLogger(_ROOT)


def get_logger(subsystem: str = "") -> logging.Logger:
    """The ``repro_torch.<subsystem>`` logger (the bare root for "")."""
    return logging.getLogger(f"{_ROOT}.{subsystem}" if subsystem else _ROOT)


def _to_level(level: str) -> int:
    if level not in LOG_LEVELS:
        raise ValueError(
            f"unknown log level {level!r}; expected one of {LOG_LEVELS}")
    return getattr(logging, level.upper())


def configure_logging(level: str = "info",
                      subsystems: Optional[Dict[str, str]] = None,
                      *, stream=None) -> logging.Logger:
    """Install the stderr handler on the ``repro_torch`` root (idempotent:
    the handler is added once, later calls only adjust levels) and set the
    root level; ``subsystems`` maps subsystem names to their own levels."""
    root = _root()
    if not root.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
        root.addHandler(handler)
        root.propagate = False
    root.setLevel(_to_level(level))
    for sub, lvl in (subsystems or {}).items():
        get_logger(sub).setLevel(_to_level(lvl))
    return root


# library default: quiet unless an entry point configures otherwise
_root().setLevel(logging.WARNING)
