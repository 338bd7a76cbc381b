"""Structured logging and step timing of the port.

A copy of ``ml_function_tpu/utils/logging.py``: the reference logs with
bare ``print`` (models.py:371 prints a tensor); here scalars go through one
structured writer, a JSONL file beside the log line."""

from __future__ import annotations

import json
import logging
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Optional

logger = logging.getLogger("ml_function_tpu_torch")
if not logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
    logger.addHandler(h)
    logger.setLevel(logging.INFO)


@dataclass
class MetricLogger:
    """Append-only JSONL scalar log + rolling step timing."""

    path: Optional[str] = None
    _t_last: float = field(default_factory=time.perf_counter)
    _f: Any = None

    def log(self, step: int, **scalars):
        now = time.perf_counter()
        rec = {"step": int(step), "dt_ms": (now - self._t_last) * 1e3,
               **{k: float(v) for k, v in scalars.items()}}
        self._t_last = now
        logger.info("step %d %s", step,
                    " ".join(f"{k}={v:.5g}" for k, v in rec.items()
                             if k != "step"))
        if self.path:
            if self._f is None:
                self._f = open(self.path, "a")
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
