"""Build the port's CUDA sources and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` beside
this file at first use; the hash covers the source, the headers it may
include from ``csrc/`` and the flags, so an edited source builds anew. Building needs the CUDA toolkit and happens only on the
machine with the card; importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "build only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: all of ``csrc/``) that is not
    built yet, one ``nvcc`` per source, all started together. Returns
    name → compiler output (``-Xptxas -v`` lists registers and spills)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, so)
        so.with_suffix(".log").write_text(out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(so))
    return lib
