"""Feature encoders of the port: DataFrame → static-shape arrays.

Counterpart of ``ml_function_tpu/features/encoders.py`` (numpy, with pandas
an optional import; copied rather than imported), the re-design of the
reference's ``data_prepare`` class (``kon/utils/data_prepare.py:56-414``):

- sparse: fillna + per-column vocab (the reference's ``LabelEncoder``,
  data_prepare.py:85-102), ids from 1 with 0 for padding/OOV, or a hashing
  mode into a fixed vocab (md5, or FNV-1a 64, the native loaders' hash);
- dense: fillna + min-max scale to [0,1] (data_prepare.py:294-301), with an
  optional log1p;
- sequences: string lists → right-padded int matrices (data_prepare.py:
  104-133), padding 0;
- SIM's hard search and DSIN's sessions.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

try:  # pandas stays optional: the native loaders need only numpy
    import pandas as pd
except Exception:  # pragma: no cover
    pd = None


def _hash_bucket(values: np.ndarray, num_buckets: int, salt: str) -> np.ndarray:
    """Stable string hashing into 1..num_buckets-1 (0 reserved)."""
    out = np.empty(len(values), np.int64)
    for i, v in enumerate(values):
        h = hashlib.md5((salt + ":" + str(v)).encode()).digest()
        out[i] = int.from_bytes(h[:8], "little") % (num_buckets - 1) + 1
    return out


def _fnv_bucket(values: np.ndarray, num_buckets: int, salt: str) -> np.ndarray:
    """FNV-1a 64 hashing into 1..num_buckets-1 — the NATIVE loaders' spec
    (native/criteo_loader.cpp): seed = fnv("<col>:"), id = 1 + fnv(value,
    seed) % (buckets-1). mode='fnv' makes the pandas path bit-identical to
    engine='native' (the parity contract of the Avazu loader)."""
    from .native_loader import fnv1a64
    out = np.empty(len(values), np.int64)
    seed = fnv1a64((salt + ":").encode())
    for i, v in enumerate(values):
        out[i] = 1 + fnv1a64(str(v).encode(), seed) % (num_buckets - 1)
    return out


@dataclass
class SparseEncoder:
    """Per-column vocab encoder. mode='vocab' fits a dict (LabelEncoder
    equivalent); mode='hash' (md5) / mode='fnv' (the native loaders' hash)
    bucket into ``hash_buckets``."""

    mode: str = "vocab"
    hash_buckets: int = 1 << 20
    min_count: int = 1
    vocabs: Dict[str, Dict[str, int]] = field(default_factory=dict)

    def fit(self, df, columns: Sequence[str]) -> "SparseEncoder":
        if self.mode != "vocab":
            return self
        for c in columns:
            col = df[c].fillna("-1").astype(str)
            counts = col.value_counts()
            vocab: Dict[str, int] = {}
            for v, n in counts.items():
                if n >= self.min_count:
                    vocab[v] = len(vocab) + 1  # 0 = pad/OOV
            self.vocabs[c] = vocab
        return self

    def transform(self, df, columns: Sequence[str]) -> np.ndarray:
        cols = []
        for c in columns:
            col = df[c].fillna("-1").astype(str).to_numpy()
            if self.mode == "hash":
                ids = _hash_bucket(col, self.hash_buckets, c)
            elif self.mode == "fnv":
                ids = _fnv_bucket(col, self.hash_buckets, c)
            else:
                vocab = self.vocabs[c]
                ids = np.asarray([vocab.get(v, 0) for v in col], np.int64)
            cols.append(ids)
        return np.stack(cols, axis=1).astype(np.int32)

    def vocab_size(self, column: str) -> int:
        if self.mode in ("hash", "fnv"):
            return self.hash_buckets
        return len(self.vocabs[column]) + 1  # + pad/OOV row

    def id_counts(self, df, column: str) -> np.ndarray:
        """Per-id occurrence counts aligned to this column's id space
        (index 0 = pad/OOV mass) — the ``freq`` input of
        ``parallel.planner.plan_field_order``/``expected_shard_loads``."""
        ids = self.transform(df, [column])[:, 0]
        return np.bincount(ids, minlength=self.vocab_size(column)
                           ).astype(np.float64)


@dataclass
class DenseEncoder:
    """fillna + min-max to [0,1] (reference dense_fea_deal,
    data_prepare.py:294-301); optional log1p for heavy-tailed counts."""

    log1p: bool = False
    mins: Optional[np.ndarray] = None
    maxs: Optional[np.ndarray] = None

    def fit(self, df, columns: Sequence[str]) -> "DenseEncoder":
        x = self._raw(df, columns)
        self.mins = np.nanmin(x, axis=0)
        self.maxs = np.nanmax(x, axis=0)
        return self

    def _raw(self, df, columns) -> np.ndarray:
        x = df[list(columns)].astype(float).to_numpy(copy=True)
        med = np.nanmean(x, axis=0)
        idx = np.where(np.isnan(x))
        if len(idx[0]):
            x[idx] = np.take(np.nan_to_num(med), idx[1])
        if self.log1p:
            x = np.log1p(np.maximum(x, 0.0))
        return x

    def transform(self, df, columns: Sequence[str]) -> np.ndarray:
        x = self._raw(df, columns)
        rng = np.maximum(self.maxs - self.mins, 1e-12)
        return ((x - self.mins) / rng).astype(np.float32)


@dataclass
class SeqEncoder:
    """'a|b|c'-style behavior strings → right-padded (N, max_len) int32.

    Shares a vocab with a SparseEncoder column when the SeqSpec's
    ``vocab_name`` points at a sparse field (reference shares by tensor name,
    ExtractLayer interactive_layer.py:82-109)."""

    max_len: int
    sep: str = "|"
    vocab: Dict[str, int] = field(default_factory=dict)

    def fit(self, series) -> "SeqEncoder":
        for s in series:
            for tok in self._tokens(s):
                if tok not in self.vocab:
                    self.vocab[tok] = len(self.vocab) + 1
        return self

    def _tokens(self, s) -> List[str]:
        if s is None or (isinstance(s, float) and np.isnan(s)):
            return []
        return [t for t in str(s).split(self.sep) if t]

    def transform(self, series, vocab: Optional[Mapping[str, int]] = None
                  ) -> np.ndarray:
        vocab = vocab if vocab is not None else self.vocab
        out = np.zeros((len(series), self.max_len), np.int32)
        for i, s in enumerate(series):
            toks = self._tokens(s)[-self.max_len:]  # keep most recent
            for j, t in enumerate(toks):
                out[i, j] = vocab.get(t, 0)
        return out

    @property
    def vocab_size(self) -> int:
        return len(self.vocab) + 1


def hard_search(seq_ids: np.ndarray, seq_cate: np.ndarray,
                target_cate: np.ndarray) -> np.ndarray:
    """SIM hard search: keep the behavior items whose category equals the
    target's, re-packed left-aligned with 0 padding. seq_ids and seq_cate
    (N, L), target_cate (N,) or (N, 1) → (N, L)."""
    n, _ = seq_ids.shape
    out = np.zeros_like(seq_ids)
    for i in range(n):
        keep = seq_ids[i][(seq_cate[i] == target_cate[i]) & (seq_ids[i] != 0)]
        out[i, :len(keep)] = keep
    return out


def sessionize(seq: np.ndarray, session_num: int, session_len: int
               ) -> np.ndarray:
    """(N, L) flat behavior sequence → (N, session_num·session_len), cut
    into sessions by position (most recent sessions last): the first
    session_num·session_len steps are kept, and a shorter sequence is
    right-padded with 0."""
    n, l = seq.shape
    out = np.zeros((n, session_num * session_len), seq.dtype)
    take = min(l, session_num * session_len)
    out[:, :take] = seq[:, :take]
    return out
