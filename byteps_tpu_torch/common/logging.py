"""Logging for the port, honouring ``BYTEPS_LOG_LEVEL``
(trace/debug/info/warning/error/fatal) through :mod:`.config`.

The port's own copy of ``byteps_tpu/common/logging.py``: loggers live
under the ``byteps_tpu_torch`` root so the two packages never share
handlers.
"""

from __future__ import annotations

import logging
import sys

_LEVELS = {
    "TRACE": 5,
    "DEBUG": logging.DEBUG,
    "INFO": logging.INFO,
    "WARNING": logging.WARNING,
    "ERROR": logging.ERROR,
    "FATAL": logging.CRITICAL,
}
_ROOT = "byteps_tpu_torch"

logging.addLevelName(5, "TRACE")


def _configure_root() -> logging.Logger:
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        from byteps_tpu_torch.common.config import get_config

        root.setLevel(_LEVELS.get(get_config().log_level, logging.INFO))
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] %(name)s %(levelname)s: %(message)s"))
        root.addHandler(handler)
        root.propagate = False
    return root


def get_logger(name: str = _ROOT) -> logging.Logger:
    _configure_root()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def bps_check(cond: bool, msg: str = "") -> None:
    """``BPS_CHECK``-style invariant assertion."""
    if not cond:
        raise RuntimeError(f"BPS_CHECK failed: {msg}")
