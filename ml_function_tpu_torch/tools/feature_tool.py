"""Pandas feature-engineering utilities of the port.

A copy of ``ml_function_tpu/tools/feature_tool.py``, the counterpart of the
reference's ``feature_tool`` (``kon/model/feature_eng/feature_transform.py:
50-863``): the host-side tabular toolkit feeding the training path.
Implemented set (reference cites):

- time-interval sequences (:57), pickle io (:65), null-count features (:237)
- rank-2/3 categorical cross features (:277-309)
- count / target-stat / group-agg features (:311-375)
- memory downcasting (:396-430)
- user→item-sequence edgelists for graph pretraining (:509-540), DeepWalk
  item embeddings (:556-604) and behavior-seq word2vec aggregates
  (:782-856), through the port's ``embedding_pretrain`` (its trainers on
  ``device``, default the card)
- EDA: CTR-vs-feature tables (:110-235 — returns DataFrames; plotting left
  to the caller's notebook, matplotlib optional)
"""

from __future__ import annotations

import itertools
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import pandas as pd
except Exception:  # pragma: no cover
    pd = None


# ---------------------------------------------------------------------------
# io + memory
# ---------------------------------------------------------------------------


def save_pickle(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def reduce_mem_usage(df, verbose: bool = False):
    """Downcast numeric columns to the smallest safe dtype (reference
    :396-430)."""
    start = df.memory_usage().sum() / 1024 ** 2
    for col in df.columns:
        if not pd.api.types.is_numeric_dtype(df[col]):
            continue
        c_min, c_max = df[col].min(), df[col].max()
        if pd.api.types.is_integer_dtype(df[col]):
            for cand in (np.int8, np.int16, np.int32, np.int64):
                if np.iinfo(cand).min <= c_min and c_max <= np.iinfo(cand).max:
                    df[col] = df[col].astype(cand)
                    break
        else:
            if (np.finfo(np.float32).min < c_min
                    and c_max < np.finfo(np.float32).max):
                df[col] = df[col].astype(np.float32)
    if verbose:
        end = df.memory_usage().sum() / 1024 ** 2
        print(f"mem {start:.1f}MB -> {end:.1f}MB")
    return df


# ---------------------------------------------------------------------------
# feature builders
# ---------------------------------------------------------------------------


def null_count_feature(df, columns: Optional[Sequence[str]] = None):
    """Per-row null count (reference null features, :237)."""
    cols = list(columns or df.columns)
    return df[cols].isnull().sum(axis=1).astype(np.int32)


def cross_features(df, columns: Sequence[str], order: int = 2,
                   sep: str = "_") -> "pd.DataFrame":
    """Rank-2/3 categorical crosses as string-concat columns (reference
    :277-309)."""
    out = {}
    for combo in itertools.combinations(columns, order):
        name = sep.join(combo) + "_cross"
        col = df[combo[0]].astype(str)
        for c in combo[1:]:
            col = col + sep + df[c].astype(str)
        out[name] = col
    return pd.DataFrame(out, index=df.index)


def count_features(df, columns: Sequence[str]) -> "pd.DataFrame":
    """Value-frequency encodings (reference count features, :311-334)."""
    out = {}
    for c in columns:
        out[f"{c}_count"] = df[c].map(df[c].value_counts()).astype(np.int32)
    return pd.DataFrame(out, index=df.index)


def stat_features(df, group_col: str, value_cols: Sequence[str],
                  stats: Sequence[str] = ("mean", "std", "min", "max"),
                  ) -> "pd.DataFrame":
    """Group-by aggregate features (reference stat/agg features, :336-375 —
    there parallelized with mp.Pool; pandas groupby is vectorized enough)."""
    out = {}
    g = df.groupby(group_col)
    for v in value_cols:
        agg = g[v].agg(list(stats))
        for s in stats:
            out[f"{group_col}_{v}_{s}"] = df[group_col].map(agg[s])
    return pd.DataFrame(out, index=df.index)


def time_interval_seq(df, user_col: str, time_col: str) -> "pd.Series":
    """Per-user successive time deltas joined as '|' strings (reference
    :57 — feeds DTS-style time features)."""
    def deltas(s):
        t = np.sort(s.to_numpy())
        d = np.diff(t, prepend=t[0] if len(t) else 0)
        return "|".join(str(int(x)) for x in d)

    return df.groupby(user_col)[time_col].transform(
        lambda s: deltas(s))


def ctr_table(df, feature_col: str, label_col: str = "label",
              bins: Optional[int] = None) -> "pd.DataFrame":
    """CTR-by-feature-value EDA table (reference plot suite, :110-235 —
    数据出表; caller plots)."""
    col = df[feature_col]
    if bins and np.issubdtype(col.dtype, np.number):
        col = pd.cut(col, bins)
    g = df.groupby(col, observed=True)[label_col]
    return pd.DataFrame({"count": g.size(), "ctr": g.mean()})


# ---------------------------------------------------------------------------
# graph/embedding bridges (reference :509-604, :643-681, :782-856)
# ---------------------------------------------------------------------------

def user_item_edgelist(df, user_col: str, item_col: str,
                       time_col: Optional[str] = None
                       ) -> List[Tuple[str, str]]:
    """Consecutive-item edges within each user's (time-ordered) sequence
    (reference generator_user_seq/list_to_seq, :509-540)."""
    if time_col:
        df = df.sort_values([user_col, time_col])
    edges = []
    for _, seq in df.groupby(user_col)[item_col]:
        items = [str(v) for v in seq.tolist()]
        edges.extend(zip(items[:-1], items[1:]))
    return edges


def item_embeddings_from_sequences(df, user_col: str, item_col: str,
                                   time_col: Optional[str] = None,
                                   dim: int = 32, num_walks: int = 40,
                                   walk_length: int = 8,
                                   seed: int = 0, device=None) -> Dict[str, np.ndarray]:
    """DeepWalk item embeddings from click sequences (reference
    generator_item_embedding, :556-604 — there an mp.Pool of per-slice jobs;
    the vectorized walker does a slice in one call)."""
    from ..embedding_pretrain import DeepWalk, from_edges

    edges = [(s, d, 1.0) for s, d in
             user_item_edgelist(df, user_col, item_col, time_col)]
    if not edges:
        return {}
    g = from_edges(edges)
    return DeepWalk(g, num_walks=num_walks, walk_length=walk_length,
                    dim=dim, seed=seed, device=device).transform()


def seq_embedding_aggregates(df, seq_col: str, dim: int = 16, window: int = 3,
                             seed: int = 0, sep: str = "|", device=None) -> "pd.DataFrame":
    """w2v over behavior strings → per-row mean/max pooled vectors (reference
    :782-856, gensim there; the port's word2vec here)."""
    from ..embedding_pretrain.walks import walks_to_skipgram_pairs
    from ..embedding_pretrain.word2vec import Word2VecConfig, train_word2vec

    seqs = [str(s).split(sep) if not (isinstance(s, float) and np.isnan(s))
            else [] for s in df[seq_col]]
    vocab: Dict[str, int] = {}
    for s in seqs:
        for tok in s:
            if tok and tok not in vocab:
                vocab[tok] = len(vocab)
    if not vocab:
        return pd.DataFrame(index=df.index)
    max_len = max(len(s) for s in seqs)
    walks = np.zeros((len(seqs), max(max_len, 2)), np.int32)
    for i, s in enumerate(seqs):
        for j, tok in enumerate(s):
            walks[i, j] = vocab[tok]
    pairs = walks_to_skipgram_pairs(walks, window=window, seed=seed)
    emb = train_word2vec(pairs, len(vocab),
                         Word2VecConfig(dim=dim, seed=seed), device=device)
    out = np.zeros((len(seqs), 2 * dim), np.float32)
    for i, s in enumerate(seqs):
        if s:
            vecs = emb[[vocab[t] for t in s if t in vocab]]
            out[i, :dim] = vecs.mean(0)
            out[i, dim:] = vecs.max(0)
    cols = ([f"{seq_col}_w2v_mean_{i}" for i in range(dim)]
            + [f"{seq_col}_w2v_max_{i}" for i in range(dim)])
    return pd.DataFrame(out, columns=cols, index=df.index)
