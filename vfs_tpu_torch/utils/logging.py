"""Text logger and JSONL metric log (counterpart of
``vfs_tpu/utils/logging.py``; the port needs nothing of the JAX package).

Replaces mmcv's rank-aware ``get_root_logger`` (reference:
mmaction/utils/logger.py:6-24): every record goes to stdout and, when
given, a log file; in a training run over several processes only rank 0
logs below ERROR.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, Optional

LOGGER_NAME = 'vfs_tpu_torch'


def _formatter() -> logging.Formatter:
    return logging.Formatter('%(asctime)s - %(name)s - %(levelname)s - '
                             '%(message)s')


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    """The package logger: a stdout handler on first use, plus a file
    handler for each new ``log_file``."""
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(_formatter())
        logger.addHandler(stream)
        logger.propagate = False
    logger.setLevel(log_level if _rank() == 0 else logging.ERROR)
    if log_file is not None and not any(
            getattr(h, 'baseFilename', None) == os.path.abspath(log_file)
            for h in logger.handlers):
        handler = logging.FileHandler(log_file)
        handler.setFormatter(_formatter())
        logger.addHandler(handler)
    return logger


class JsonlLogger:
    """Append-only JSONL metric log (the reference TextLoggerHook writes a
    twin .log.json; tools/analysis/analyze_logs.py parses it)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: Dict[str, Any]):
        record = dict(record)
        record.setdefault('time', time.time())
        with open(self.path, 'a') as f:
            f.write(json.dumps(record, default=_json_default) + '\n')


def _json_default(obj):
    import numpy as np
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return str(obj)
