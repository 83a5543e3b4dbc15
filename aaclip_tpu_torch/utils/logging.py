"""A logger that always writes to the run's log file, whatever the root
logger's configuration."""

from __future__ import annotations

import logging
import os


def setup_logger(name: str, log_path: str) -> logging.Logger:
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    # reset handlers so repeated main() calls do not duplicate lines
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fh = logging.FileHandler(log_path, encoding="utf-8")
    fh.setFormatter(logging.Formatter("INFO:%(name)s:%(message)s"))
    logger.addHandler(fh)
    return logger
