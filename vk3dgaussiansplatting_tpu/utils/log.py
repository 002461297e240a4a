"""Logging — the reference's Dev/Log facility (Log.{h,cpp}).

Same four severities (`write`, `warning`, `error`, `alert`); errors raise
instead of popping a Win32 message box, alerts print prominently instead.
"""

from __future__ import annotations

import logging
import sys

_logger = logging.getLogger("vk3dgs")
if not _logger.handlers:
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[Log]: %(message)s"))
    _logger.addHandler(handler)
    _logger.setLevel(logging.INFO)


def write(msg: str) -> None:
    _logger.info(msg)


def warning(msg: str) -> None:
    _logger.warning("~~~ WARNING ~~~ %s", msg)


def error(msg: str) -> None:
    _logger.error("~~~ ERROR ~~~ %s", msg)
    raise RuntimeError(msg)


def alert(title: str, msg: str) -> None:
    """Log::writeAlert equivalent (used for final benchmark averages)."""
    _logger.info("=== %s ===\n%s", title, msg)
