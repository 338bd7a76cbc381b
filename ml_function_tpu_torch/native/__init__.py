"""Build the port's C++ data loaders with g++ and load them with ctypes.

``<name>.cpp`` in this directory (the port's own copies of the JAX
package's ``native/criteo_loader.cpp``, ``behavior_loader.cpp`` and
``walk_engine.cpp``) is
compiled at first use into ``build/lib<name>-<hash>.so`` beside it, as
``ops/kernels/_build.py`` builds the CUDA sources; the hash covers the
source and the flags, so an edited source builds anew. Importing this
module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict

SRC = Path(__file__).resolve().parent
BUILD = SRC / "build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    pass


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source and the flags."""
    digest = hashlib.sha256((SRC / f"{name}.cpp").read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cpp`` unless it is built already; returns the
    library's path. Raises ``NativeBuildError`` where g++ is missing or
    fails."""
    so = library_path(name)
    if so.exists():
        return so
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, str(SRC / f"{name}.cpp"), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"g++ unavailable: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"g++ failed for {name}.cpp:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic publish
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cpp``, built first if needed.
    Thread-safe."""
    with _LOCK:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build(name)))
        return _loaded[name]
