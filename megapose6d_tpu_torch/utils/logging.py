"""Logging with the seconds since import in every record.

Counterpart of `megapose6d_tpu/utils/logging.py`.
"""

from __future__ import annotations

import logging
import time

_START = time.monotonic()


class ElapsedFormatter(logging.Formatter):
    def format(self, record):
        record.elapsed = f"{time.monotonic() - _START:8.1f}s"
        return super().format(record)


def get_logger(name: str) -> logging.Logger:
    """A logger at INFO that writes `[elapsed name level] message` to
    stderr (once, however often it is asked for)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(ElapsedFormatter("[%(elapsed)s %(name)s %(levelname)s] %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
