"""File + console logger factory (counterpart of ``fenet/utils/logger.py``)."""

from __future__ import annotations

import logging
import os


def get_logger(filename: str, verbosity: int = 1, name=None) -> logging.Logger:
    level = {0: logging.DEBUG, 1: logging.INFO, 2: logging.WARNING}[verbosity]
    formatter = logging.Formatter(
        "[%(asctime)s][%(filename)s][line:%(lineno)d][%(levelname)s] %(message)s"
    )
    logger = logging.getLogger(name or filename)
    logger.setLevel(level)
    if not logger.handlers:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename, "a")
        fh.setFormatter(formatter)
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    return logger
