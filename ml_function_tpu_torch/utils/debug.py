"""Debug and reliability utilities of the port.

Counterpart of ``ml_function_tpu/utils/debug.py``:

- ``enable_nan_checks``: autograd's anomaly mode (a backward that makes a
  NaN raises at the operation that made it), where the reference toggles
  ``jax_debug_nans``;
- ``find_nonfinite``: the key paths of non-finite values of a module's
  parameters and buffers, or of a nested dict of tensors or arrays;
- ``StepWatchdog``: a wall-clock watchdog around train steps that fires a
  callback (by default: log and dump every thread's stack) when a step
  outlasts its deadline;
- ``profile``: a ``torch.profiler`` trace of a scope, written to a
  directory.
"""

from __future__ import annotations

import contextlib
import faulthandler
import os
import sys
import threading
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from .logging import logger


def enable_nan_checks(on: bool = True) -> None:
    torch.autograd.set_detect_anomaly(on)


def _leaves(tree: Any, prefix: str):
    if isinstance(tree, torch.nn.Module):
        for name, t in list(tree.named_parameters()) + list(tree.named_buffers()):
            yield prefix + name.replace(".", "/"), t
    elif isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def find_nonfinite(tree: Any, prefix: str = "") -> list:
    """Key paths of the floating leaves that hold a NaN or an infinity (a
    module's parameters and buffers by their '/'-joined names, or a nested
    dict / list of tensors and arrays); other leaves are skipped."""
    bad = []
    for key, leaf in _leaves(tree, prefix):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad.append(key)
        else:
            arr = np.asarray(leaf)
            if (np.issubdtype(arr.dtype, np.floating)
                    and not bool(np.isfinite(arr).all())):
                bad.append(key)
    return bad


class StepWatchdog:
    """Fires if ``ping()`` isn't called within ``timeout_s``: a hung step
    (a wedged kernel, a dead data loader) gets surfaced instead of hanging
    the job silently."""

    def __init__(self, timeout_s: float = 300.0,
                 on_timeout: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout or self._default_handler
        self._timer: Optional[threading.Timer] = None
        self._stopped = False

    def _default_handler(self):
        logger.error("watchdog: no step completed in %.0fs — dumping stacks",
                     self.timeout_s)
        faulthandler.dump_traceback(file=sys.stderr)

    def _arm(self):
        self._timer = threading.Timer(self.timeout_s, self.on_timeout)
        self._timer.daemon = True
        self._timer.start()

    def ping(self):
        """Call after each completed step."""
        if self._timer:
            self._timer.cancel()
        if not self._stopped:
            self._arm()

    def __enter__(self):
        self._arm()
        return self

    def __exit__(self, *exc):
        self._stopped = True
        if self._timer:
            self._timer.cancel()
        return False


@contextlib.contextmanager
def profile(trace_dir: Optional[str]):
    """A ``torch.profiler`` trace of the scope (host, and the card where
    there is one), written as a Chrome trace ``trace.json`` under
    ``trace_dir``; a no-op when ``trace_dir`` is empty."""
    if not trace_dir:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
