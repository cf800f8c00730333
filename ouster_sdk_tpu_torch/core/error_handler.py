"""Pluggable error handling for sources.

Rebuild of the reference error handler (ref: ouster_client/include/ouster/
error_handler.h:14, error_handler.cpp): sources report recoverable problems
(id mismatches, decode failures, dropped data) through a callback with a
severity; the default logs and raises on ERROR.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable

from .logging import logger


class Severity(Enum):
    WARNING = "WARNING"
    ERROR = "ERROR"


ErrorHandler = Callable[[Severity, str], None]


def default_error_handler(severity: Severity, message: str) -> None:
    """(ref: error_handler.cpp default behavior)."""
    if severity == Severity.WARNING:
        logger().warning(message)
    else:
        logger().error(message)
        raise RuntimeError(message)


def logging_error_handler(severity: Severity, message: str) -> None:
    """Log-only handler (never raises)."""
    if severity == Severity.WARNING:
        logger().warning(message)
    else:
        logger().error(message)
