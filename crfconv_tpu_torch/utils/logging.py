"""Logger setup.

Counterpart of ``crfconv_tpu/utils/logging.py``: one console handler (on
standard output) and, given a file, one file handler, each added once.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

LOGGER = "crfconv_tpu_torch"


def init_logger(
    log_file: Optional[str] = None,
    name: str = LOGGER,
    level: int = logging.INFO,
) -> logging.Logger:
    """The ``name`` logger at ``level``, writing to the console and, where
    ``log_file`` is given, to that file."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    if not any(
        isinstance(h, logging.StreamHandler) for h in logger.handlers
    ):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    if log_file is not None and not any(
        isinstance(h, logging.FileHandler) for h in logger.handlers
    ):
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
