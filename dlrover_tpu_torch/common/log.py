"""Logging setup shared by every dlrover_tpu_torch process (a copy of
dlrover_tpu/common/log.py: per-process configured logger)."""

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(name)s:%(lineno)d] %(message)s"
)


def get_logger(name: str, level: int | None = None) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.propagate = False
    if level is None:
        level_name = os.environ.get("DLROVER_TPU_LOG_LEVEL", "INFO").upper()
        level = getattr(logging, level_name, logging.INFO)
    logger.setLevel(level)
    return logger


default_logger = get_logger("dlrover_tpu_torch")
