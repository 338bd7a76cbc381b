"""Vectorized random walkers: DeepWalk (uniform/weighted) and node2vec (p,q).

A copy in the port of ``ml_function_tpu/embedding_pretrain/walks.py``
(numpy, host-side; the same walks and pairs for the same seed).

The reference walks one node at a time in Python
(``kon/model/embedding/walk_core_model.py:89-115``; node2vec transition
prep ``:34-85``). Here ALL walks advance together, one step per NumPy op:
- DeepWalk: per-node alias tables over out-edge weights;
- node2vec: per-EDGE alias tables over the p/q-biased second-order
  distribution (same preprocessing as the reference, ``:47-85``), with the
  current edge id carried through the walk so each step is one batched
  table lookup.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .alias import FlatAliasTables, build_alias
from .graph import CSRGraph


def _node_tables(g: CSRGraph) -> FlatAliasTables:
    tables = []
    for v in range(g.num_nodes):
        w = g.weights[g.indptr[v]:g.indptr[v + 1]]
        tables.append(build_alias(w))
    return FlatAliasTables(tables)


def deepwalk_walks(g: CSRGraph, num_walks: int = 80, walk_length: int = 10,
                   seed: int = 0) -> np.ndarray:
    """(num_walks * n, walk_length) int32 node-id walks; dead-ends repeat.

    Reference: shuffled uniform walks (``deepwalk.py:13-22``)."""
    rng = np.random.default_rng(seed)
    tables = _node_tables(g)
    n = g.num_nodes
    starts = np.concatenate([rng.permutation(n) for _ in range(num_walks)])
    walks = np.empty((len(starts), walk_length), np.int64)
    cur = starts.copy()
    walks[:, 0] = cur
    deg = g.degrees()
    for t in range(1, walk_length):
        has_out = deg[cur] > 0
        # sample a neighbor slot for every walker (safe for deg=0 via clip)
        safe_cur = np.where(has_out, cur, 0)
        slot = tables.sample(safe_cur, rng)
        nxt = g.indices[np.minimum(g.indptr[safe_cur] + slot,
                                   g.num_edges - 1)]
        cur = np.where(has_out, nxt, cur)
        walks[:, t] = cur
    return walks.astype(np.int32)


def _edge_tables(g: CSRGraph, p: float, q: float) -> FlatAliasTables:
    """Second-order alias table per edge (prev→cur): over cur's out-edges,
    weight/p back to prev, weight to common neighbors, weight/q otherwise
    (reference get_alias_edge, walk_core_model.py:47-64)."""
    tables = []
    nbr_sets = [set(g.neighbors(v).tolist()) for v in range(g.num_nodes)]
    for e in range(g.num_edges):
        # find source of edge e
        prev = int(np.searchsorted(g.indptr, e, side="right") - 1)
        cur = int(g.indices[e])
        lo, hi = g.indptr[cur], g.indptr[cur + 1]
        nxts = g.indices[lo:hi]
        w = g.weights[lo:hi].astype(np.float64).copy()
        for j, x in enumerate(nxts):
            if x == prev:
                w[j] /= p
            elif x not in nbr_sets[prev]:
                w[j] /= q
        tables.append(build_alias(w))
    return FlatAliasTables(tables)


def node2vec_walks(g: CSRGraph, num_walks: int = 80, walk_length: int = 10,
                   p: float = 1.0, q: float = 1.0, seed: int = 0) -> np.ndarray:
    """p,q-biased walks (reference ``node2vec.py:7-29``), carrying edge ids so
    every step is one vectorized alias draw."""
    rng = np.random.default_rng(seed)
    node_tables = _node_tables(g)
    edge_tables = _edge_tables(g, p, q)
    n = g.num_nodes
    deg = g.degrees()
    starts = np.concatenate([rng.permutation(n) for _ in range(num_walks)])
    walks = np.empty((len(starts), walk_length), np.int64)
    cur = starts.copy()
    walks[:, 0] = cur

    # first step: first-order draw; track the edge id taken
    has_out = deg[cur] > 0
    safe_cur = np.where(has_out, cur, 0)
    slot = node_tables.sample(safe_cur, rng)
    edge = np.minimum(g.indptr[safe_cur] + slot, g.num_edges - 1)
    cur = np.where(has_out, g.indices[edge], cur)
    if walk_length > 1:
        walks[:, 1] = cur
    for t in range(2, walk_length):
        has_out = deg[cur] > 0
        slot = edge_tables.sample(np.where(has_out, edge, 0), rng)
        new_edge = np.minimum(g.indptr[np.where(has_out, cur, 0)] + slot,
                              g.num_edges - 1)
        edge = np.where(has_out, new_edge, edge)
        cur = np.where(has_out, g.indices[new_edge], cur)
        walks[:, t] = cur
    return walks.astype(np.int32)


def walks_to_skipgram_pairs(walks: np.ndarray, window: int = 5,
                            seed: int = 0) -> np.ndarray:
    """(W, L) walks → (P, 2) (center, context) pairs within ``window``."""
    w, l = walks.shape
    pairs = []
    for off in range(1, window + 1):
        if off >= l:
            break
        a = walks[:, :-off].reshape(-1)
        b = walks[:, off:].reshape(-1)
        pairs.append(np.stack([a, b], 1))
        pairs.append(np.stack([b, a], 1))
    out = np.concatenate(pairs, axis=0)
    rng = np.random.default_rng(seed)
    rng.shuffle(out)
    return out.astype(np.int32)
