"""Data preparation of the port: SIM's hard search and DSIN's sessions.

Counterpart of ``hard_search`` and ``sessionize`` in
``ml_function_tpu/features/encoders.py`` (numpy only, copied rather than
imported); the column encoders come with the slice that ports the training
shell.
"""

from __future__ import annotations

import numpy as np


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
