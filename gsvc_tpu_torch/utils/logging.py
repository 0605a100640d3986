"""Logging bootstrap and metrics sink of the CLIs (port of
gsvc_tpu/utils/logging.py: ``setup_logging``, ``MetricsWriter``,
``dump_config``): stdlib logging to stderr and to a log file in the output
directory, scalars as JSON lines, the resolved config as YAML."""

from __future__ import annotations

import json
import logging
import os
import pathlib
import sys
import time
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


class MetricsWriter:
    """Append-only JSONL scalar sink: one ``{"step", "time", **scalars}``
    line a ``write``, each scalar with ``__float__`` as a float."""

    def __init__(self, model_path: str, name: str = "metrics.jsonl"):
        p = pathlib.Path(model_path)
        p.mkdir(parents=True, exist_ok=True)
        self._f = open(p / name, "a")

    def write(self, step: int, **scalars):
        rec = {"step": step, "time": time.time()}
        for k, v in scalars.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def dump_config(cfg, model_path: str):
    """Write the resolved config to ``model_path/cfg_args.yaml``."""
    from gsvc_tpu_torch.config import save_config

    p = pathlib.Path(model_path)
    p.mkdir(parents=True, exist_ok=True)
    save_config(cfg, str(p / "cfg_args.yaml"))
