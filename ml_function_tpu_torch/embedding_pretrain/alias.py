"""Alias-method sampling (Walker's method), vectorized: a copy in the port
of ``ml_function_tpu/embedding_pretrain/alias.py`` (numpy, host-side; the
same draws from the same numpy generator).

Counterpart of the reference's ``backone_optimize.py:5-105`` (per-table build
+ scalar ``alias_sample``); here builds are batch-friendly and draws are fully
vectorized over any number of simultaneous samplers — required by the
vectorized random walkers in ``walks.py``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def build_alias(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """probs (k,) non-negative, sums to anything → (accept (k,), alias (k,))."""
    k = len(probs)
    p = np.asarray(probs, np.float64)
    s = p.sum()
    if k == 0 or s <= 0:
        return np.ones(max(k, 0)), np.zeros(max(k, 0), np.int64)
    q = p * (k / s)
    accept = np.zeros(k)
    alias = np.zeros(k, np.int64)
    small = [i for i in range(k) if q[i] < 1.0]
    large = [i for i in range(k) if q[i] >= 1.0]
    while small and large:
        s_i, l_i = small.pop(), large.pop()
        accept[s_i] = q[s_i]
        alias[s_i] = l_i
        q[l_i] = q[l_i] - (1.0 - q[s_i])
        (small if q[l_i] < 1.0 else large).append(l_i)
    for rest in (large, small):
        for i in rest:
            accept[i] = 1.0
    return accept, alias


def alias_sample(accept: np.ndarray, alias: np.ndarray, rng: np.random.Generator,
                 size=None) -> np.ndarray:
    """Draw `size` samples from one alias table."""
    k = len(accept)
    i = rng.integers(0, k, size=size)
    u = rng.random(size=size)
    return np.where(u < accept[i], i, alias[i])


class FlatAliasTables:
    """Many variable-size alias tables packed flat for vectorized draws.

    ``offsets[t]`` is the start of table t; table t has ``sizes[t]`` entries.
    Used for per-node (DeepWalk degree tables) and per-edge (node2vec
    second-order) distributions.
    """

    def __init__(self, tables):
        sizes = np.asarray([len(a) for a, _ in tables], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
        self.sizes = sizes
        self.accept = (np.concatenate([a for a, _ in tables])
                       if tables else np.zeros(0))
        self.alias = (np.concatenate([b for _, b in tables])
                      if tables else np.zeros(0, np.int64))

    def sample(self, table_ids: np.ndarray, rng: np.random.Generator
               ) -> np.ndarray:
        """For each t in table_ids draw one index in [0, sizes[t])."""
        sz = self.sizes[table_ids]
        off = self.offsets[table_ids]
        i = (rng.random(len(table_ids)) * sz).astype(np.int64)
        u = rng.random(len(table_ids))
        flat = off + i
        return np.where(u < self.accept[flat], i, self.alias[flat])


def simulate(probs=(0.2, 0.5, 0.3), n: int = 200_000, seed: int = 0) -> float:
    """Statistical self-test (reference ``simulate()``,
    backone_optimize.py:87-105): returns max abs frequency error."""
    rng = np.random.default_rng(seed)
    accept, alias = build_alias(np.asarray(probs))
    draws = alias_sample(accept, alias, rng, size=n)
    freq = np.bincount(draws, minlength=len(probs)) / n
    return float(np.max(np.abs(freq - np.asarray(probs) / np.sum(probs))))
