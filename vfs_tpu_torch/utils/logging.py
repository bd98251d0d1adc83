"""Text logger (the part of ``vfs_tpu/utils/logging.py`` the eval path
calls; the port needs nothing of the JAX package).

Replaces mmcv's rank-aware ``get_root_logger`` (reference:
mmaction/utils/logger.py:6-24): one process logs, so every record goes to
stdout and, when given, a log file.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

LOGGER_NAME = 'vfs_tpu_torch'


def _formatter() -> logging.Formatter:
    return logging.Formatter('%(asctime)s - %(name)s - %(levelname)s - '
                             '%(message)s')


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    """The package logger: a stdout handler on first use, plus a file
    handler for each new ``log_file``."""
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(_formatter())
        logger.addHandler(stream)
        logger.setLevel(log_level)
        logger.propagate = False
    if log_file is not None and not any(
            getattr(h, 'baseFilename', None) == os.path.abspath(log_file)
            for h in logger.handlers):
        handler = logging.FileHandler(log_file)
        handler.setFormatter(_formatter())
        logger.addHandler(handler)
    return logger
