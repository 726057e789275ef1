"""Named logger with an optional file sink (port of
``simvg_tpu/utils/logger.py``)."""

from __future__ import annotations

import logging
import os
from typing import Optional

_LOGGER_NAME = "simvg_tpu_torch"
_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_root_logger(log_file: Optional[str] = None,
                    log_level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(sh)
        logger.setLevel(log_level)
        logger.propagate = False
    # baseFilename is absolute: compare absolute paths or a repeated
    # call with a relative log_file attaches a duplicate handler
    if log_file is not None and not any(
        isinstance(h, logging.FileHandler)
        and getattr(h, "baseFilename", None) == os.path.abspath(log_file)
        for h in logger.handlers
    ):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger
