"""Logging facade: stdout/stderr/rotating-file sinks behind one logger.

Rebuild of the reference logging layer (ref: ouster_client/include/ouster/
impl/logging.h:16-50, src/logging.cpp — spdlog behind a PIMPL singleton,
exposed as init_logger, ref: client.h:85)."""

from __future__ import annotations

import logging
import logging.handlers
import sys
from typing import Optional

_LOGGER_NAME = "ouster_sdk_tpu_torch"

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}


def logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def init_logger(log_level: str, log_file_path: str = "",
                rotating_max_size_in_bytes: int = 0,
                rotating_max_files: int = 0) -> bool:
    """(ref: client.h:85 init_logger): configure sink + level. A file path
    enables a (optionally rotating) file sink; otherwise logs go to
    stderr."""
    level = _LEVELS.get(log_level.lower())
    if level is None:
        return False
    log = logger()
    log.setLevel(level)
    for h in list(log.handlers):
        log.removeHandler(h)
    fmt = logging.Formatter(
        "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s")
    if log_file_path:
        if rotating_max_size_in_bytes > 0:
            handler: logging.Handler = \
                logging.handlers.RotatingFileHandler(
                    log_file_path,
                    maxBytes=rotating_max_size_in_bytes,
                    backupCount=max(rotating_max_files, 1))
        else:
            handler = logging.FileHandler(log_file_path)
    else:
        handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(fmt)
    log.addHandler(handler)
    return True
