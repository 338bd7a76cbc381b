"""Host-side batch iteration of the port (numpy only).

Counterpart of ``iter_batches`` in ``ml_function_tpu/train/loop.py``; the
training loop comes with the training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator

import numpy as np


def iter_batches(data: Dict[str, Any], batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 pad_last: bool = True) -> Iterator[Dict[str, Any]]:
    """Yield static-shape batches from a dict-of-arrays dataset.

    ``data`` maps name → (N, …) array, with ``seq`` an optional sub-dict.
    The tail batch is padded to ``batch_size`` with copies of row 0 and a
    ``weight`` vector marks the real rows (every batch carries ``weight``).
    """
    n = len(data["label"])
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)

    for start in range(0, n, batch_size):
        sl = idx[start:start + batch_size]
        actual = len(sl)
        if actual < batch_size:
            if drop_last or not pad_last:
                return
            sl = np.concatenate([sl, np.zeros(batch_size - actual, np.int64)])
        batch = {}
        for k, v in data.items():
            if k == "seq":
                batch["seq"] = {name: a[sl] for name, a in v.items()}
            else:
                batch[k] = v[sl]
        w = np.zeros(batch_size, np.float32)
        w[:actual] = 1.0
        batch["weight"] = w
        yield batch
