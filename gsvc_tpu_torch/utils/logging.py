"""Logging bootstrap of the CLIs (port of ``setup_logging``,
gsvc_tpu/utils/logging.py:32): stdlib logging to stderr and to a log file
in the output directory."""

from __future__ import annotations

import logging
import os
import pathlib
import sys
from typing import Optional


def _stderr_is_file(path: pathlib.Path) -> bool:
    """True when stderr is already redirected into ``path`` (a run started
    with ``>> output.log 2>&1``): a file handler for the same file would
    write every line twice."""
    try:
        st_err = os.fstat(sys.stderr.fileno())
        st_f = os.stat(path)
        return (st_err.st_dev, st_err.st_ino) == (st_f.st_dev, st_f.st_ino)
    except (OSError, ValueError):
        return False


def setup_logging(model_path: Optional[str] = None,
                  filename: str = "output.log") -> logging.Logger:
    """The ``gsvc_tpu_torch`` logger at INFO, writing to stderr and, given
    ``model_path``, to ``model_path/filename`` (the directory is made)."""
    logger = logging.getLogger("gsvc_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(message)s", "%H:%M:%S")
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if model_path:
        p = pathlib.Path(model_path)
        p.mkdir(parents=True, exist_ok=True)
        target = p / filename
        if not (target.exists() and _stderr_is_file(target)):
            fh = logging.FileHandler(target)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger
