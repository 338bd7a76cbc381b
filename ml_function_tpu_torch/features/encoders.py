"""Data preparation of the port: SIM's hard search.

Counterpart of ``hard_search`` in ``ml_function_tpu/features/encoders.py``
(numpy only, copied rather than imported); the column encoders come with
the slice that ports the training shell.
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
