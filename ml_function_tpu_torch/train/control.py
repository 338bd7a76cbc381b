"""Eval-driven training control: early stopping, plateau LR, history.

The port's own copy of ``ml_function_tpu/train/control.py`` (pure Python).
The reference's Keras callbacks (``EarlyStopping(patience=10)``,
``ReduceLROnPlateau``) become host-side controllers that ``fit`` consults
between steps; a plateau reduction reaches the optimizer through
``optimizers.set_learning_rate``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


def _infer_mode(monitor: str) -> str:
    """max for score-like metrics, min for loss-like."""
    m = monitor.lower()
    if any(k in m for k in ("auc", "acc", "hit", "mrr", "f1", "gauc")):
        return "max"
    return "min"


@dataclass
class MetricMonitor:
    """Tracks the best value of one eval metric."""

    monitor: str = "auc"
    mode: str = ""                 # '' -> inferred from the metric name
    min_delta: float = 0.0
    best: float = math.nan
    best_step: int = -1

    def __post_init__(self):
        if not self.mode:
            self.mode = _infer_mode(self.monitor)
        if self.mode not in ("max", "min"):
            raise ValueError(f"mode must be 'max'|'min', got {self.mode!r}")

    def improved(self, value: float, step: int) -> bool:
        better = (math.isnan(self.best)
                  or (self.mode == "max" and value > self.best + self.min_delta)
                  or (self.mode == "min" and value < self.best - self.min_delta))
        if better:
            self.best, self.best_step = value, step
        return better


@dataclass
class EarlyStopping:
    """Stop after ``patience`` consecutive evals without improvement."""

    patience: int = 10
    monitor: str = "auc"
    mode: str = ""
    min_delta: float = 0.0
    _bad: int = 0
    tracker: MetricMonitor = field(init=False)

    def __post_init__(self):
        self.tracker = MetricMonitor(self.monitor, self.mode, self.min_delta)

    def update(self, value: float, step: int) -> bool:
        """Record one eval; returns True when training should STOP."""
        if self.tracker.improved(value, step):
            self._bad = 0
            return False
        self._bad += 1
        return self._bad >= self.patience

    @property
    def best(self) -> float:
        return self.tracker.best

    @property
    def best_step(self) -> int:
        return self.tracker.best_step


@dataclass
class ReduceLROnPlateau:
    """Multiply the LR by ``factor`` after ``patience`` evals without
    improvement. Call ``update``; when it returns a float, push it into the
    optimizer with ``optimizers.set_learning_rate`` (which needs an optimizer
    built with ``inject_lr=True``)."""

    base_lr: float
    factor: float = 0.5
    patience: int = 2
    min_lr: float = 1e-6
    cooldown: int = 0
    monitor: str = "auc"
    mode: str = ""
    min_delta: float = 0.0
    _bad: int = 0
    _cool: int = 0
    lr: float = field(init=False)
    tracker: MetricMonitor = field(init=False)

    def __post_init__(self):
        self.lr = self.base_lr
        self.tracker = MetricMonitor(self.monitor, self.mode, self.min_delta)

    def update(self, value: float, step: int = 0) -> Optional[float]:
        """Returns the NEW lr when a reduction fires, else None."""
        if self.tracker.improved(value, step):
            self._bad = 0
            return None
        if self._cool > 0:
            self._cool -= 1
            return None
        self._bad += 1
        if self._bad < self.patience or self.lr <= self.min_lr:
            return None
        self.lr = max(self.lr * self.factor, self.min_lr)
        self._bad = 0
        self._cool = self.cooldown
        return self.lr


@dataclass
class History:
    """Per-eval records: [{'step': int, 'auc': …, 'logloss': …, 'lr': …}]."""

    records: List[Dict[str, float]] = field(default_factory=list)

    def append(self, step: int, summary: Dict[str, float], **extra):
        self.records.append({"step": step, **summary, **extra})

    def series(self, key: str) -> List[float]:
        return [r[key] for r in self.records if key in r]
