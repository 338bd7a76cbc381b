"""Out-of-core behavior-sequence stream of the port.

Counterpart of ``ml_function_tpu/features/behavior_stream.py``: the
behavior data gets the streaming path Criteo TSVs have (newline-snapped
chunks, a background parse thread double-buffered behind the train step,
disjoint chunk sharding) by reusing the ``CriteoFileIterator`` machinery
with a behavior-sequence parser. The native parser is the port's own copy,
``ml_function_tpu_torch/native/behavior_loader.cpp``, built with g++ at
first use (``ml_function_tpu_torch/native/__init__.py``).

Format (CSV with header): ``label,<sparse cols...>,<hist cols...>`` where
history cells are ``|``-separated id lists. Ids must be INTEGERS; the
stateless encode is ``id % (buckets-1) + 1`` (0 = pad), so the FeatureSet
is fixed by the bucket space and no vocab pass over the file is needed.
Histories right-pad / keep-most-recent exactly like
``SeqEncoder.transform``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import native
from .native_loader import CriteoFileIterator
from .schema import FeatureSet, SeqSpec, SparseSpec

_BLOCK = threading.Lock()
_blib: Optional[ctypes.CDLL] = None


def _get_blib() -> ctypes.CDLL:
    global _blib
    with _BLOCK:
        if _blib is None:
            lib = native.load("behavior_loader")
            lib.mlfb_count_rows.restype = ctypes.c_int64
            lib.mlfb_count_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            lib.mlfb_parse_behavior.restype = ctypes.c_int64
            lib.mlfb_parse_behavior.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
            _blib = lib
    return _blib


def native_available() -> bool:
    try:
        _get_blib()
        return True
    except Exception:
        return False


def encode_int_ids(ids: np.ndarray, buckets: int) -> np.ndarray:
    """Stateless integer-id encode into 1..buckets-1 (0 = pad); pad slots
    (id 0) stay 0."""
    out = (ids % (buckets - 1)) + 1
    return np.where(ids == 0, 0, out).astype(np.int32)


def _parse_int_lists(col: np.ndarray, max_len: int) -> np.ndarray:
    """(N,) array of '3|19|2' strings -> (N, max_len) int64, right-padded,
    most-recent kept — vectorized: one big split + one array conversion
    instead of a Python loop per row."""
    n = len(col)
    out = np.zeros((n, max_len), np.int64)
    if n == 0:
        return out
    cells: List[List[str]] = [
        [t for t in str(c).split("|") if t] if c is not None else []
        for c in col]
    counts = np.asarray([len(c) for c in cells], np.int64)
    if counts.sum() == 0:
        return out
    flat = np.asarray([int(t) for cell in cells for t in cell], np.int64)
    offs = np.concatenate([[0], np.cumsum(counts)])
    for i in range(n):  # placement loop only; parsing above is batched
        k = min(int(counts[i]), max_len)
        if k:
            out[i, :k] = flat[offs[i + 1] - k:offs[i + 1]]
    return out


def behavior_stream_feature_set(*, item_buckets: int, cate_buckets: int,
                                seq_len: int, embed_dim: int = 8,
                                long_seq_len: int = 0) -> FeatureSet:
    """The fixed schema of the canonical behavior stream layout:
    candidate ``item``/``cate`` + ``hist_item``/``hist_cate`` histories
    (+ optional ``hist_long`` lifelong item stream)."""
    seqs = [SeqSpec("hist_item", item_buckets, seq_len, vocab_name="item",
                    dim=embed_dim),
            SeqSpec("hist_cate", cate_buckets, seq_len, vocab_name="cate",
                    dim=embed_dim)]
    if long_seq_len:
        seqs.append(SeqSpec("hist_long", item_buckets, long_seq_len,
                            vocab_name="item", dim=embed_dim))
    return FeatureSet(
        sparse=(SparseSpec("item", item_buckets, vocab_name="item",
                           dim=embed_dim),
                SparseSpec("cate", cate_buckets, vocab_name="cate",
                           dim=embed_dim)),
        seq=tuple(seqs))


class BehaviorFileIterator(CriteoFileIterator):
    """Streaming behavior-sequence reader: same chunking / double-buffered
    producer / batch-carry machinery as the Criteo stream, different parser.

    Canonical columns: ``label,item,cate,hist_item,hist_cate[,hist_long]``
    (header required; extra columns ignored). Yields batches shaped for the
    behavior models: ``{dense, sparse (B, 2), seq: {hist_*}, label}``.
    """

    def __init__(self, path: str, batch_size: int, *,
                 seq_len: int = 90, long_seq_len: int = 0,
                 item_buckets: int = 1 << 20, cate_buckets: int = 1 << 10,
                 chunk_bytes: int = 16 << 20,
                 shard: Optional[Tuple[int, int]] = None,
                 engine: str = "auto"):
        """``engine``: 'auto' (the native C++ parser when g++ builds it)
        | 'native' | 'python'."""
        super().__init__(path, batch_size, chunk_bytes=chunk_bytes,
                         shard=shard)
        self.seq_len = seq_len
        self.long_seq_len = long_seq_len
        self.item_buckets = item_buckets
        self.cate_buckets = cate_buckets
        if engine == "auto":
            engine = "native" if native_available() else "python"
        elif engine == "native":
            _get_blib()  # raise early with the g++ error
        self.engine = engine
        # read the header eagerly: with chunk sharding only shard 0 sees
        # chunk 0, so every worker must learn the column order up front
        with open(path, "r") as f:
            self._header_line = f.readline().rstrip("\n")
        self._header: List[str] = self._header_line.split(",")

    def feature_set(self, embed_dim: int = 8) -> FeatureSet:
        return behavior_stream_feature_set(
            item_buckets=self.item_buckets, cate_buckets=self.cate_buckets,
            seq_len=self.seq_len, embed_dim=embed_dim,
            long_seq_len=self.long_seq_len)

    def _columns(self) -> Dict[str, int]:
        cols = {name: i for i, name in enumerate(self._header)}
        need = ["label", "item", "cate", "hist_item", "hist_cate"]
        if self.long_seq_len:
            need.append("hist_long")
        missing = [c for c in need if c not in cols]
        if missing:
            raise ValueError(f"behavior stream {self.path} is missing "
                             f"columns {missing} (header {self._header})")
        return cols

    def _parse(self, chunk: bytes) -> Dict[str, np.ndarray]:
        # chunk 0 carries the header row — strip it for either engine
        hdr = self._header_line.encode()
        if chunk.startswith(hdr) and chunk[len(hdr):len(hdr) + 1] in (b"\n",
                                                                      b""):
            chunk = chunk[len(hdr) + 1:]
        if self.engine == "native":
            return self._parse_native(chunk)
        return self._parse_python(chunk)

    def _parse_native(self, chunk: bytes) -> Dict[str, np.ndarray]:
        lib = _get_blib()
        cols = self._columns()
        n = int(lib.mlfb_count_rows(chunk, len(chunk)))
        L, LL = self.seq_len, max(self.long_seq_len, 1)
        labels = np.empty(n, np.float32)
        items = np.empty(n, np.int32)
        cates = np.empty(n, np.int32)
        hi = np.empty((n, L), np.int32)
        hc = np.empty((n, L), np.int32)
        hl = np.empty((n, LL), np.int32) if self.long_seq_len else \
            np.empty((0, 1), np.int32)

        def ptr(a, ty):
            return a.ctypes.data_as(ctypes.POINTER(ty))

        got = lib.mlfb_parse_behavior(
            chunk, len(chunk), self.seq_len, self.long_seq_len or 0,
            self.item_buckets, self.cate_buckets,
            cols["label"], cols["item"], cols["cate"], cols["hist_item"],
            cols["hist_cate"], cols.get("hist_long", -1)
            if self.long_seq_len else -1,
            ptr(labels, ctypes.c_float), ptr(items, ctypes.c_int32),
            ptr(cates, ctypes.c_int32), ptr(hi, ctypes.c_int32),
            ptr(hc, ctypes.c_int32),
            ptr(hl, ctypes.c_int32) if self.long_seq_len else None, 0)
        if got != n:
            raise RuntimeError(f"native behavior parse wrote {got} rows, counted {n}")
        seq = {"hist_item": hi, "hist_cate": hc}
        if self.long_seq_len:
            seq["hist_long"] = hl
        return {"dense": np.zeros((n, 0), np.float32),
                "sparse": np.stack([items, cates], axis=1),
                "seq": seq, "label": labels}

    def _parse_python(self, chunk: bytes) -> Dict[str, np.ndarray]:
        lines = chunk.decode().splitlines()
        cols = self._columns()
        rows = [ln.split(",") for ln in lines if ln]
        get = lambda c: np.asarray([r[cols[c]] for r in rows], object)

        label = np.asarray([float(x) for x in get("label")], np.float32)
        item = encode_int_ids(
            np.asarray([int(x) for x in get("item")], np.int64),
            self.item_buckets)
        cate = encode_int_ids(
            np.asarray([int(x) for x in get("cate")], np.int64),
            self.cate_buckets)
        seq = {
            "hist_item": encode_int_ids(
                _parse_int_lists(get("hist_item"), self.seq_len),
                self.item_buckets),
            "hist_cate": encode_int_ids(
                _parse_int_lists(get("hist_cate"), self.seq_len),
                self.cate_buckets),
        }
        if self.long_seq_len:
            seq["hist_long"] = encode_int_ids(
                _parse_int_lists(get("hist_long"), self.long_seq_len),
                self.item_buckets)
        return {"dense": np.zeros((len(rows), 0), np.float32),
                "sparse": np.stack([item, cate], axis=1),
                "seq": seq, "label": label}


def load_behavior_stream(path: str, embed_dim: int = 8,
                         **kw) -> Tuple[FeatureSet, Dict]:
    """Whole-file load through the STREAM parser (eval sets / parity with
    the out-of-core path) — bypasses batching so no tail row is dropped."""
    it = BehaviorFileIterator(path, batch_size=1, **kw)
    parts = [it._parse(c) for c in it._read_chunks()]
    if not parts:
        raise ValueError(f"no rows in {path}")
    out: Dict = {}
    for k in parts[0]:
        if k == "seq":
            out["seq"] = {n: np.concatenate([p["seq"][n] for p in parts])
                          for n in parts[0]["seq"]}
        else:
            out[k] = np.concatenate([p[k] for p in parts])
    return it.feature_set(embed_dim), out
