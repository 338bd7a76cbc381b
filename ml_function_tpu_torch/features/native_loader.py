"""Native (C++) Criteo TSV and Avazu CSV loaders of the port.

Counterpart of ``ml_function_tpu/features/native_loader.py``. It binds the
port's own copy of the C++ parser, ``ml_function_tpu_torch/native/
criteo_loader.cpp``, built with g++ at first use into the git-ignored
``native/build/`` (``ml_function_tpu_torch/native/__init__.py``), through
ctypes, and exposes:

- :func:`load_criteo`: whole-file parse to numpy arrays;
- :class:`CriteoFileIterator`: a streaming chunked reader with a background
  prefetch thread, for files larger than host memory;
- :func:`load_avazu`: the Avazu CSV with the pandas path's column plan;
- :func:`py_reference_parse`: a slow pure-Python implementation of the
  same encoding, which the tests hold the native parse against.

Batches are numpy arrays; ``models.base.as_tensors`` (or the train step)
moves them to the model's device.

Encoding (shared with the C++ side):
  label  = float(field0)            (empty → 0)
  dense  = log1p(max(v, 0)) if log1p else v      (missing → 0)
  sparse = 1 + FNV1a64("<col>:<bytes>") % (buckets-1), missing → 0
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..native import NativeBuildError

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the native library. Thread-safe."""
    global _lib
    with _LOCK:
        if _lib is None:
            lib = native.load("criteo_loader")
            lib.mlf_count_rows.restype = ctypes.c_int64
            lib.mlf_count_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.c_int]
            lib.mlf_parse_criteo.restype = ctypes.c_int64
            lib.mlf_parse_criteo.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
            lib.mlf_parse_avazu.restype = ctypes.c_int64
            lib.mlf_parse_avazu.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_char, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int]
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


def parse_buffer(buf, *, n_dense: int = 13, n_sparse: int = 26,
                 hash_buckets: int = 1 << 20, log1p: bool = True,
                 sparse_cols: Optional[Sequence[str]] = None,
                 n_threads: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Parse a Criteo TSV byte buffer (bytes / mmap / any buffer-protocol
    object — zero-copy) → arrays dict."""
    lib = get_lib()
    nt = _threads(n_threads)
    cols = list(sparse_cols or [f"C{i+1}" for i in range(n_sparse)])
    if len(cols) != n_sparse:
        raise ValueError(f"{len(cols)} sparse_cols for n_sparse={n_sparse}")
    view = np.frombuffer(buf, np.uint8)  # zero-copy over bytes AND mmap
    addr, nbytes = view.ctypes.data, view.size
    n = lib.mlf_count_rows(addr, nbytes, nt)
    dense = np.zeros((n, n_dense), np.float32)
    sparse = np.zeros((n, n_sparse), np.int32)
    label = np.zeros((n,), np.float32)
    if n:
        rows = lib.mlf_parse_criteo(
            addr, nbytes, n_dense, n_sparse, hash_buckets, int(log1p),
            "\n".join(cols).encode(),
            dense.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            sparse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nt)
        if rows != n:
            raise RuntimeError(f"native parse wrote {rows} rows, counted {n}")
    return {"dense": dense, "sparse": sparse, "label": label}


def load_criteo(path: str, *, n_dense: int = 13, n_sparse: int = 26,
                hash_buckets: int = 1 << 20, log1p: bool = True,
                n_threads: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Whole-file native parse (mmap'd — no Python-side copy of the text)."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return parse_buffer(b"", n_dense=n_dense, n_sparse=n_sparse,
                                hash_buckets=hash_buckets, log1p=log1p)
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            return parse_buffer(mm, n_dense=n_dense, n_sparse=n_sparse,
                                hash_buckets=hash_buckets, log1p=log1p,
                                n_threads=n_threads)


def _tree_concat(a, b):
    """Row-concatenate two (possibly nested) dict-of-array batches."""
    if isinstance(a, dict):
        return {k: _tree_concat(a[k], b[k]) for k in a}
    return np.concatenate([a, b])


def _tree_slice(v, sl):
    if isinstance(v, dict):
        return {k: _tree_slice(x, sl) for k, x in v.items()}
    return v[sl]


class CriteoFileIterator:
    """Streaming chunked reader: yields encoded batches from a Criteo TSV of
    any size with a single background prefetch thread (double-buffered — the
    next chunk parses on the host while the current one trains on the card).

    Chunks are ``chunk_bytes`` slices snapped to newline boundaries; each is
    parsed natively and sliced into ``batch_size`` batches. The final partial
    batch of each epoch is dropped (static shapes for the train step).

    Several processes: pass ``shard=(process_index, process_count)`` and
    each consumes a disjoint round-robin subset of chunks from the SAME
    file.
    """

    def __init__(self, path: str, batch_size: int, *, n_dense: int = 13,
                 n_sparse: int = 26, hash_buckets: int = 1 << 20,
                 log1p: bool = True, chunk_bytes: int = 64 << 20,
                 n_threads: Optional[int] = None,
                 shard: Optional[Tuple[int, int]] = None):
        self.path = path
        self.batch_size = batch_size
        self.kw = dict(n_dense=n_dense, n_sparse=n_sparse,
                       hash_buckets=hash_buckets, log1p=log1p,
                       n_threads=n_threads)
        self.chunk_bytes = max(chunk_bytes, 1 << 16)
        if shard is not None and not (0 <= shard[0] < shard[1]):
            raise ValueError(f"bad shard {shard}")
        self.shard = shard

    def _read_chunks(self) -> Iterator[bytes]:
        idx = 0
        with open(self.path, "rb") as f:
            tail = b""
            while True:
                block = f.read(self.chunk_bytes)
                if not block:
                    if tail and self._mine(idx):
                        yield tail
                    return
                block = tail + block
                cut = block.rfind(b"\n")
                if cut < 0:
                    tail = block
                    continue
                tail = block[cut + 1:]
                if self._mine(idx):
                    yield block[:cut + 1]
                idx += 1

    def _mine(self, chunk_idx: int) -> bool:
        return (self.shard is None
                or chunk_idx % self.shard[1] == self.shard[0])

    def _parse(self, chunk: bytes) -> Dict[str, np.ndarray]:
        """Chunk bytes -> dict of arrays; subclasses override (the
        behavior-sequence stream reuses the chunking/double-buffer/carry
        machinery with its own parser, features/behavior_stream.py)."""
        return parse_buffer(chunk, **self.kw)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        bs = self.batch_size
        chunks = self._read_chunks()
        parsed: List[Optional[Dict[str, np.ndarray]]] = []
        done = threading.Event()
        ready = threading.Semaphore(0)
        slots = threading.Semaphore(2)  # double buffer

        def producer():
            try:
                for c in chunks:
                    slots.acquire()
                    parsed.append(self._parse(c))
                    ready.release()
            except BaseException as e:  # surfaced in consumer
                parsed.append(e)  # type: ignore[arg-type]
                ready.release()
            finally:
                done.set()
                ready.release()

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        carry: Optional[Dict[str, np.ndarray]] = None
        while True:
            ready.acquire()
            if not parsed:
                if done.is_set():
                    break
                continue
            item = parsed.pop(0)
            slots.release()
            if isinstance(item, BaseException):
                raise item
            if carry is not None:
                item = _tree_concat(carry, item)
            n_full = len(item["label"]) // bs * bs
            for i in range(0, n_full, bs):
                yield _tree_slice(item, slice(i, i + bs))
            carry = (_tree_slice(item, slice(n_full, None))
                     if n_full < len(item["label"]) else None)
        t.join()


# ---------------------------------------------------------------------------
# Avazu-format categorical CSV


def avazu_columns(header: Sequence[str], label_col: str = "click",
                  drop: Sequence[str] = ("id",)):
    """Output-column plan from a CSV header: every field except label/id
    becomes a hashed categorical, with ``hour`` (YYMMDDHH) split into
    ``hour_of_day`` + ``day`` derived columns appended at the end — the
    exact column set/order of ``avazu_csv_pipeline`` (pandas path)."""
    if label_col not in header:
        raise ValueError(f"label column {label_col!r} not in header "
                         f"{list(header)[:6]}...")
    label_idx = header.index(label_col)
    hour_idx = header.index("hour") if "hour" in header else -1
    skip = set(drop) | {label_col, "hour"}
    out_cols, field_idx, mode = [], [], []
    for i, c in enumerate(header):
        if c in skip:
            continue
        out_cols.append(c)
        field_idx.append(i)
        mode.append(0)
    if hour_idx >= 0:
        out_cols += ["hour_of_day", "day"]
        field_idx += [hour_idx, hour_idx]
        mode += [1, 2]
    return out_cols, field_idx, mode, label_idx, hour_idx


def parse_avazu_buffer(buf, header: Sequence[str], *,
                       hash_buckets: int = 1 << 20,
                       label_col: str = "click",
                       delim: str = ",",
                       n_threads: Optional[int] = None
                       ) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Parse a HEADERLESS Avazu CSV body buffer → (out_cols, arrays).
    Encoding = SparseEncoder mode='fnv' on the pandas-equivalent string
    view of each field: int-typed columns canonicalize to decimal, empty
    fields become '-1' (fillna contract), ``hour`` splits into
    hour_of_day/day. Bit-parity with the pandas fnv path is pinned in
    tests; columns pandas would type as FLOAT (missing values in an int
    column, scientific notation) diverge — real Avazu has none."""
    lib = get_lib()
    nt = _threads(n_threads)
    out_cols, field_idx, mode, label_idx, hour_idx = avazu_columns(
        list(header), label_col)
    view = np.frombuffer(buf, np.uint8)
    addr, nbytes = view.ctypes.data, view.size
    n = lib.mlf_count_rows(addr, nbytes, nt)
    sparse = np.zeros((n, len(out_cols)), np.int32)
    label = np.zeros((n,), np.float32)
    if n:
        fi = np.asarray(field_idx, np.int32)
        md = np.asarray(mode, np.int32)
        rows = lib.mlf_parse_avazu(
            addr, nbytes, delim.encode(), len(header), label_idx, hour_idx,
            len(out_cols), fi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            md.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), hash_buckets,
            "\n".join(out_cols).encode(),
            sparse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nt)
        if rows < 0:
            raise RuntimeError("native avazu parse: bad spec")
        if rows != n:  # blank lines are skipped by the parser AND counter
            sparse, label = sparse[:rows], label[:rows]
    return out_cols, {"dense": np.zeros((len(label), 0), np.float32),
                      "sparse": sparse, "label": label}


def load_avazu(path: str, *, hash_buckets: int = 1 << 20,
               label_col: str = "click",
               n_threads: Optional[int] = None
               ) -> Tuple[List[str], Dict[str, np.ndarray]]:
    """Whole-file native Avazu parse (mmap'd body, header read separately)."""
    with open(path, "rb") as f:
        head = f.readline()
        header = head.decode().rstrip("\r\n").split(",")
        size = os.fstat(f.fileno()).st_size
        body_off = len(head)
        if size <= body_off:
            return parse_avazu_buffer(b"", header,
                                      hash_buckets=hash_buckets,
                                      label_col=label_col)
        with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
            body = np.frombuffer(mm, np.uint8)[body_off:]
            try:
                return parse_avazu_buffer(body, header,
                                          hash_buckets=hash_buckets,
                                          label_col=label_col,
                                          n_threads=n_threads)
            finally:
                del body  # release the mmap export before close


# ---------------------------------------------------------------------------
# Pure-Python reference of the exact spec — for parity tests only.

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211
_MASK64 = (1 << 64) - 1


def fnv1a64(data: bytes, h: int = _FNV_OFFSET) -> int:
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def py_reference_parse(text: str, *, n_dense: int = 13, n_sparse: int = 26,
                       hash_buckets: int = 1 << 20, log1p: bool = True,
                       sparse_cols: Optional[Sequence[str]] = None
                       ) -> Dict[str, np.ndarray]:
    """Slow reference implementation of the native encoding spec."""
    cols = list(sparse_cols or [f"C{i+1}" for i in range(n_sparse)])
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    n = len(lines)
    dense = np.zeros((n, n_dense), np.float32)
    sparse = np.zeros((n, n_sparse), np.int32)
    label = np.zeros((n,), np.float32)
    for r, line in enumerate(lines):
        fields = line.split("\t")
        fields += [""] * (1 + n_dense + n_sparse - len(fields))
        label[r] = float(fields[0]) if fields[0] else 0.0
        for i in range(n_dense):
            f = fields[1 + i]
            v = float(f) if f else 0.0
            dense[r, i] = np.log1p(max(v, 0.0)) if log1p else v
        for j in range(n_sparse):
            f = fields[1 + n_dense + j]
            if not f:
                sparse[r, j] = 0
            else:
                h = fnv1a64(f.encode(),
                            fnv1a64((cols[j] + ":").encode()))
                sparse[r, j] = 1 + h % (hash_buckets - 1)
    return {"dense": dense, "sparse": sparse, "label": label}
