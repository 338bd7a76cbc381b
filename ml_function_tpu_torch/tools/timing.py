"""Device timing on the CUDA card by CUDA events."""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def event_ms(fn: Callable[[], object], reps: int = 25, inner: int = 10,
             warmup: int = 3) -> float:
    """Median over ``reps`` samples of the time of one call of ``fn``: each
    sample records CUDA events around ``inner`` calls issued back to back and
    divides by ``inner``. With ``inner`` > 1 the host's time to issue a call
    is hidden wherever it is shorter than the device's time for it; with
    ``inner`` = 1 an idle card waits for the host and the sample shows it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)
