"""Native (C++) random-walk engine bindings of the port.

``ml_function_tpu_torch/native/walk_engine.cpp`` (the port's own copy of the
JAX package's source, the same bytes) is built with g++ at first use into
the git-ignored ``native/build/`` by ``ml_function_tpu_torch/native``, as
the port's data loaders are; the JAX package's library is never built or
loaded. The functions are drop-in counterparts of ``walks.deepwalk_walks`` /
``walks.node2vec_walks``, and give the JAX package's native walks for the
same seed and thread count:

- per-node alias tables built multithreaded in C++ (the reference builds
  them node-by-node in Python, ``walk_core_model.py:34-85``);
- walks fan out across threads with one splitmix64 stream per walk, so
  results are deterministic for a given seed regardless of thread count;
- node2vec needs NO per-edge table: exact rejection sampling against the
  first-order draw (the reference precomputes an alias table per edge,
  ``walk_core_model.py:47-64`` — O(Σ deg) memory and the slowest prep step).

The sampled distributions match the NumPy walkers' exactly (statistically —
streams differ).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from .. import native
from ..native import NativeBuildError
from .graph import CSRGraph

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)

__all__ = ["NativeBuildError", "get_lib", "native_available",
           "deepwalk_walks_native", "node2vec_walks_native"]


def get_lib() -> ctypes.CDLL:
    """The walk engine, built first if needed; raises ``NativeBuildError``
    where g++ is missing or fails."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = native.load("walk_engine")
            lib.mlf_build_node_alias.restype = None
            lib.mlf_build_node_alias.argtypes = [
                ctypes.c_int64, _i64p, _f64p, _f32p, _i32p, ctypes.c_int]
            lib.mlf_deepwalk.restype = None
            lib.mlf_deepwalk.argtypes = [
                ctypes.c_int64, _i64p, _i32p, _f32p, _i32p, ctypes.c_int64,
                _i32p, ctypes.c_int, ctypes.c_uint64, _i32p, ctypes.c_int]
            lib.mlf_node2vec.restype = None
            lib.mlf_node2vec.argtypes = [
                ctypes.c_int64, _i64p, _i32p, _f32p, _i32p, ctypes.c_double,
                ctypes.c_double, ctypes.c_int64, _i32p, ctypes.c_int,
                ctypes.c_uint64, _i32p, ctypes.c_int]
            _lib = lib
    return _lib


def native_available() -> bool:
    try:
        get_lib()
        return True
    except NativeBuildError:
        return False


def _threads(n_threads: Optional[int]) -> int:
    return n_threads or min(os.cpu_count() or 1, 32)


def _sorted_csr(g: CSRGraph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR copies with each node's adjacency sorted by neighbor id (the
    engine binary-searches membership); weights permute alongside."""
    indptr = np.ascontiguousarray(g.indptr, np.int64)
    indices = np.ascontiguousarray(g.indices, np.int32)
    weights = np.ascontiguousarray(g.weights, np.float64)
    # global stable sort by (row, neighbor) == per-row neighbor sort
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees())
    order = np.lexsort((indices, rows))
    return indptr, indices[order], weights[order]


def _alias(indptr: np.ndarray, weights: np.ndarray,
           n_threads: int) -> Tuple[np.ndarray, np.ndarray]:
    lib = get_lib()
    m = len(weights)
    prob = np.empty(m, np.float32)
    alias = np.empty(m, np.int32)
    lib.mlf_build_node_alias(
        len(indptr) - 1, indptr.ctypes.data_as(_i64p),
        weights.ctypes.data_as(_f64p), prob.ctypes.data_as(_f32p),
        alias.ctypes.data_as(_i32p), n_threads)
    return prob, alias


def _starts(n: int, num_walks: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.permutation(n) for _ in range(num_walks)]
                          ).astype(np.int32)


def deepwalk_walks_native(g: CSRGraph, num_walks: int = 80,
                          walk_length: int = 10, seed: int = 0,
                          n_threads: Optional[int] = None) -> np.ndarray:
    """Drop-in for ``walks.deepwalk_walks`` (same start schedule and
    dead-end-repeat semantics), multithreaded C++."""
    lib = get_lib()
    nt = _threads(n_threads)
    indptr = np.ascontiguousarray(g.indptr, np.int64)
    indices = np.ascontiguousarray(g.indices, np.int32)
    weights = np.ascontiguousarray(g.weights, np.float64)
    prob, alias = _alias(indptr, weights, nt)
    starts = _starts(g.num_nodes, num_walks, seed)
    walks = np.empty((len(starts), walk_length), np.int32)
    lib.mlf_deepwalk(
        g.num_nodes, indptr.ctypes.data_as(_i64p),
        indices.ctypes.data_as(_i32p), prob.ctypes.data_as(_f32p),
        alias.ctypes.data_as(_i32p), len(starts),
        starts.ctypes.data_as(_i32p), walk_length, seed + 1,
        walks.ctypes.data_as(_i32p), nt)
    return walks


def node2vec_walks_native(g: CSRGraph, num_walks: int = 80,
                          walk_length: int = 10, p: float = 1.0,
                          q: float = 1.0, seed: int = 0,
                          n_threads: Optional[int] = None) -> np.ndarray:
    """Drop-in for ``walks.node2vec_walks``: exact p,q-biased second-order
    walks via rejection sampling (no per-edge alias build)."""
    lib = get_lib()
    nt = _threads(n_threads)
    indptr, indices, weights = _sorted_csr(g)
    prob, alias = _alias(indptr, weights, nt)
    starts = _starts(g.num_nodes, num_walks, seed)
    walks = np.empty((len(starts), walk_length), np.int32)
    lib.mlf_node2vec(
        g.num_nodes, indptr.ctypes.data_as(_i64p),
        indices.ctypes.data_as(_i32p), prob.ctypes.data_as(_f32p),
        alias.ctypes.data_as(_i32p), float(p), float(q), len(starts),
        starts.ctypes.data_as(_i32p), walk_length, seed + 1,
        walks.ctypes.data_as(_i32p), nt)
    return walks
