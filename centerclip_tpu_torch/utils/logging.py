# coding=utf-8
"""Logging + metric writing (port of the JAX package's `utils/logging.py`;
reference: utils/log.py, TensorBoard usage in main.py:179-182,360-372).

The port runs one process, so the reference's queue-based multiprocess
logging (and the JAX package's process-0 filter) collapses to one stderr
handler and a file.  Scalars go to a JSONL file (always) and to TensorBoard
when `torch.utils.tensorboard` can be imported.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Dict, Optional


def setup_logging(log_file: Optional[str] = None,
                  level: int = logging.INFO) -> None:
    handlers = [logging.StreamHandler(sys.stderr)]
    if log_file is not None:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    fmt = logging.Formatter(
        "%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d,%H:%M:%S")
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers.clear()
    for h in handlers:
        h.setFormatter(fmt)
        root.addHandler(h)


class MetricWriter:
    """Scalar sink: JSONL always, TensorBoard when importable."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:       # no tensorboard package: JSONL only
            return
        self._tb = SummaryWriter(logdir)

    def log(self, scalars: Dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time(), **scalars}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, global_step=step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
