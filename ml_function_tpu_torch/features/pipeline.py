"""Input pipelines of the port: files → FeatureSet + static-shape arrays.

Counterpart of ``ml_function_tpu/features/pipeline.py``, the reference's
per-script data wrangling (``example/ctr_example/un_seq.py:36-54``,
``seq.py:39-44``) as reusable pipelines. Batches are numpy arrays;
``models.base.as_tensors`` (or the train step) moves them to the model's
device. The pandas engines import pandas inside the functions that need
it; the native engines need only numpy and g++.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .encoders import DenseEncoder, SeqEncoder, SparseEncoder, hard_search, sessionize
from .schema import DenseSpec, FeatureSet, SeqSpec, SparseSpec


def _native_ok(path: str) -> bool:
    """True when the C++ loader applies: toolchain builds and the file is a
    headerless Criteo TSV (first line starts with a numeric label field)."""
    try:
        from .native_loader import native_available

        if not native_available():
            return False
        with open(path, "rb") as f:
            first = f.readline().split(b"\t", 1)[0]
        float(first)
        return True
    except (OSError, ValueError):
        return False


def criteo_csv_pipeline(path: str, n_dense: int = 13, n_sparse: int = 26,
                        embed_dim: int = 8, hash_features: bool = False,
                        hash_buckets: int = 1 << 20,
                        label_col: str = "label",
                        sep: str = "\t",
                        engine: str = "auto") -> Tuple[FeatureSet, Dict]:
    """Criteo-format CSV/TSV (label, I1..I13, C1..C26 — the reference's
    un_seq layout, un_seq.py:39-40) → (FeatureSet, arrays).

    ``engine``: 'native' uses the multithreaded C++ parser+hash-encoder
    (features/native_loader.py — requires headerless TSV + hash_features);
    'pandas' the reference-equivalent path; 'auto' picks native when its
    preconditions hold and the toolchain is available.
    """
    if engine == "auto":
        engine = "native" if (hash_features and sep == "\t"
                              and _native_ok(path)) else "pandas"
    if engine == "native":
        from .native_loader import load_criteo

        if not hash_features:
            raise ValueError("engine='native' hash-encodes: needs "
                             "hash_features=True")
        data = load_criteo(path, n_dense=n_dense, n_sparse=n_sparse,
                           hash_buckets=hash_buckets)
        fs = FeatureSet(
            dense=tuple(DenseSpec(f"I{i+1}") for i in range(n_dense)),
            sparse=tuple(SparseSpec(f"C{i+1}", vocab_size=hash_buckets,
                                    dim=embed_dim) for i in range(n_sparse)),
        )
        return fs, data

    import pandas as pd

    df = pd.read_csv(path, sep=sep)
    dense_cols = [f"I{i+1}" for i in range(n_dense)]
    sparse_cols = [f"C{i+1}" for i in range(n_sparse)]
    if label_col not in df.columns:  # headerless criteo tsv
        names = [label_col] + dense_cols + sparse_cols
        df = pd.read_csv(path, sep=sep, names=names)

    de = DenseEncoder(log1p=True).fit(df, dense_cols)
    se = SparseEncoder(mode="hash" if hash_features else "vocab",
                       hash_buckets=hash_buckets).fit(df, sparse_cols)
    fs = FeatureSet(
        dense=tuple(DenseSpec(c) for c in dense_cols),
        sparse=tuple(SparseSpec(c, vocab_size=se.vocab_size(c), dim=embed_dim)
                     for c in sparse_cols),
    )
    data = {
        "dense": de.transform(df, dense_cols),
        "sparse": se.transform(df, sparse_cols),
        "label": df[label_col].to_numpy(np.float32),
    }
    return fs, data


def behavior_csv_pipeline(path: str, *, item_col: str = "item",
                          cate_col: str = "cate",
                          hist_item_col: str = "hist_item",
                          hist_cate_col: str = "hist_cate",
                          seq_len: int = 90, embed_dim: int = 8,
                          label_col: str = "label", sep: str = ",",
                          session_shape: Optional[Tuple[int, int]] = None,
                          with_hard_search: bool = False
                          ) -> Tuple[FeatureSet, Dict]:
    """Behavior-sequence CSV ('a|b|c' history strings — the reference's seq
    layout, seq.py:39-41 / data_prepare.py:150-217) → (FeatureSet, arrays).

    ``with_hard_search`` adds a ``hist_item_hard`` sequence filtered to the
    candidate's category (SIM GSU stage, data_prepare.py:136-147).
    """
    import pandas as pd

    df = pd.read_csv(path, sep=sep)
    item_enc = SeqEncoder(max_len=seq_len).fit(df[hist_item_col])
    item_enc.fit(df[item_col].astype(str))
    cate_enc = SeqEncoder(max_len=seq_len).fit(df[hist_cate_col])
    cate_enc.fit(df[cate_col].astype(str))

    hist_item = item_enc.transform(df[hist_item_col])
    hist_cate = cate_enc.transform(df[hist_cate_col])
    cand_item = item_enc.transform(df[item_col].astype(str))[:, 0]
    cand_cate = cate_enc.transform(df[cate_col].astype(str))[:, 0]

    if session_shape:
        hist_item = sessionize(hist_item, *session_shape)
        hist_cate = sessionize(hist_cate, *session_shape)
        seq_len = session_shape[0] * session_shape[1]

    iv, cv = item_enc.vocab_size, cate_enc.vocab_size
    seqs = [SeqSpec("hist_item", iv, seq_len, vocab_name="item", dim=embed_dim,
                    session_shape=session_shape),
            SeqSpec("hist_cate", cv, seq_len, vocab_name="cate", dim=embed_dim,
                    session_shape=session_shape)]
    seq_data = {"hist_item": hist_item, "hist_cate": hist_cate}
    if with_hard_search:
        seq_data["hist_item_hard"] = hard_search(hist_item, hist_cate,
                                                 cand_cate[:, None])
        seqs.append(SeqSpec("hist_item_hard", iv, seq_len, vocab_name="item",
                            dim=embed_dim))

    fs = FeatureSet(
        sparse=(SparseSpec("item", iv, vocab_name="item", dim=embed_dim),
                SparseSpec("cate", cv, vocab_name="cate", dim=embed_dim)),
        seq=tuple(seqs),
    )
    data = {
        "dense": np.zeros((len(df), 0), np.float32),
        "sparse": np.stack([cand_item, cand_cate], axis=1).astype(np.int32),
        "seq": seq_data,
        "label": df[label_col].to_numpy(np.float32),
    }
    return fs, data


def avazu_csv_pipeline(path: str, embed_dim: int = 8,
                       hash_features: bool = False,
                       hash_buckets: int = 1 << 20,
                       label_col: str = "click",
                       max_rows: Optional[int] = None,
                       engine: str = "auto",
                       hash_mode: str = "hash") -> Tuple[FeatureSet, Dict]:
    """Avazu-format CSV (click + 22 categorical fields incl. hour) →
    (FeatureSet, arrays). The hour column is split into (day-of-week-ish, hour-of-day)
    categorical fields, the standard treatment.

    ``engine``: 'native' uses the multithreaded C++ parser+FNV-hash encoder
    (native/criteo_loader.cpp::mlf_parse_avazu — requires
    ``hash_features=True``); 'pandas' the in-memory path; 'auto' picks
    native when hash_features is on and the toolchain builds; the native
    engine is the at-scale route. ``hash_mode`` ('hash' = md5 | 'fnv' = the native spec) selects
    the pandas hash; engine='native' always hashes FNV, and
    pandas+hash_mode='fnv' is bit-identical to it (parity-tested)."""
    import pandas as pd

    if engine == "auto":
        from .native_loader import native_available
        engine = ("native" if hash_features and max_rows is None
                  and native_available() else "pandas")
    if engine == "native":
        if not hash_features:
            raise ValueError("engine='native' hash-encodes: needs "
                             "hash_features=True")
        from .native_loader import load_avazu
        cols, data = load_avazu(path, hash_buckets=hash_buckets,
                                label_col=label_col)
        fs = FeatureSet(sparse=tuple(
            SparseSpec(c, vocab_size=hash_buckets, dim=embed_dim)
            for c in cols))
        return fs, data

    df = pd.read_csv(path, nrows=max_rows)
    drop = {label_col, "id"}
    if "hour" in df.columns:  # YYMMDDHH ints
        h = df["hour"].astype(int)
        df["hour_of_day"] = (h % 100).astype(str)
        df["day"] = ((h // 100) % 100).astype(str)
        drop.add("hour")
    sparse_cols = [c for c in df.columns if c not in drop]

    se = SparseEncoder(mode=hash_mode if hash_features else "vocab",
                       hash_buckets=hash_buckets).fit(df, sparse_cols)
    fs = FeatureSet(
        sparse=tuple(SparseSpec(c, vocab_size=se.vocab_size(c), dim=embed_dim)
                     for c in sparse_cols),
    )
    data = {
        "dense": np.zeros((len(df), 0), np.float32),
        "sparse": se.transform(df, sparse_cols),
        "label": df[label_col].to_numpy(np.float32),
    }
    return fs, data
