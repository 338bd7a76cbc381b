"""Device timing on the CUDA card: CUDA events, device time by kernel name
from ``torch.profiler``, and the card's peak rates."""

from __future__ import annotations

import statistics
import time
from collections import defaultdict
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile

# The H100 SXM's peak rates (NVIDIA's data sheet), against which the bounds
# of a kernel's time are taken.
PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12       # HBM3 rate
PEAK_TF32_FLOPS = 495e12   # dense TF32 tensor-core rate


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


def _kernel_intervals(prof):
    """(name, start_us, end_us) of every kernel the trace saw on the card.
    Ranges that annotate the device timeline (``Optimizer.step#Adam.step``)
    span gaps and are not kernels: they are left out."""
    out = []
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            out.append((evt.name, evt.time_range.start, evt.time_range.end))
    return out


def profile_device(fn: Callable[[], object], n: int, counts: bool = False):
    """``n`` calls of ``fn`` under ``torch.profiler``: (device ms by kernel
    name a call, busiest first; device busy ms a call; window ms a call),
    and with ``counts`` a fourth item, each kernel name's launches over the
    ``n`` calls. It traces the card's activity alone: tracing the host's
    operators too stretches the window of a step that launches many small
    kernels, and takes seconds more to read back."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    intervals = _kernel_intervals(prof)
    by_name = defaultdict(float)
    for name, s, e in intervals:
        by_name[name] += (e - s) / 1e3 / n
    busy, hi = 0.0, None
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if hi is None or s > hi:
            busy += e - s
            hi = e
        elif e > hi:
            busy += e - hi
            hi = e
    out = (dict(sorted(by_name.items(), key=lambda kv: -kv[1])),
           busy / 1e3 / n, wall * 1e3 / n)
    if counts:
        seen = defaultdict(int)
        for name, _, _ in intervals:
            seen[name] += 1
        out += (dict(seen),)
    return out
