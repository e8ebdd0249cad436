"""Logging setup (stdlib logging), the port's own copy of
``streamyolo_tpu/utils/logger.py``: ``get_logger`` and ``setup_logger``."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_LOGGER_NAME = "streamyolo_torch"
_FORMAT = "%(asctime)s | %(levelname)s | %(name)s:%(lineno)d - %(message)s"


def get_logger(name: Optional[str] = None) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME if name is None else f"{_LOGGER_NAME}.{name}")
    root = logging.getLogger(_LOGGER_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(logging.INFO)
    return logger


def setup_logger(save_dir: str, distributed_rank: int = 0, filename: str = "log.txt",
                 mode: str = "a") -> logging.Logger:
    """``get_logger()`` that also appends to ``save_dir/filename`` on rank 0
    (``distributed_rank``); every rank logs to stderr."""
    logger = get_logger()
    if distributed_rank != 0:
        return logger
    path = os.path.abspath(os.path.join(save_dir, filename))
    root = logging.getLogger(_LOGGER_NAME)
    if not any(getattr(h, "baseFilename", None) == path for h in root.handlers):
        handler = logging.FileHandler(path, mode=mode)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
    return logger
