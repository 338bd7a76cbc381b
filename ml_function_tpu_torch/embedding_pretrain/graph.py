"""Graph container for embedding pretraining, a copy in the port of
``ml_function_tpu/embedding_pretrain/graph.py`` (numpy, host-side).

Counterpart of the reference's networkx-based utilities
(``kon/model/embedding/util_tool.py:7-58``): edgelist io + CSR adjacency.
CSR (not networkx objects) because the walkers are vectorized NumPy — the
reference walks node-by-node in Python (``walk_core_model.py:89-115``), which
is the slowest part of its pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class CSRGraph:
    """Directed graph in CSR form with contiguous int node ids."""

    indptr: np.ndarray    # (n+1,)
    indices: np.ndarray   # (m,) neighbor node ids
    weights: np.ndarray   # (m,) edge weights
    node_names: List[str]  # idx -> original name
    name_to_id: Dict[str, int]

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def out_weight_sums(self) -> np.ndarray:
        return np.add.reduceat(
            np.concatenate([self.weights, [0.0]]),
            np.minimum(self.indptr[:-1], len(self.weights) - 1)
        ) * (np.diff(self.indptr) > 0)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]


def from_edges(edges: Sequence[Tuple[str, str, float]],
               undirected: bool = False) -> CSRGraph:
    if undirected:
        edges = list(edges) + [(d, s, w) for s, d, w in edges]
    names: Dict[str, int] = {}
    for s, d, _ in edges:
        for n in (s, d):
            if n not in names:
                names[n] = len(names)
    n = len(names)
    src = np.asarray([names[s] for s, _, _ in edges], np.int64)
    dst = np.asarray([names[d] for _, d, _ in edges], np.int64)
    w = np.asarray([e[2] for e in edges], np.float64)
    order = np.argsort(src, kind="stable")
    src, dst, w = src[order], dst[order], w[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, src + 1, 1)
    indptr = np.cumsum(indptr)
    node_names = [None] * n
    for name, i in names.items():
        node_names[i] = name
    return CSRGraph(indptr=indptr, indices=dst, weights=w,
                    node_names=node_names, name_to_id=names)


def read_edgelist(path: str, weighted: bool = False,
                  undirected: bool = False) -> CSRGraph:
    """Read 'src dst [weight]' lines (reference ``save_edgelist`` format,
    util_tool.py:19-25; wiki dataset ``Wiki_edgelist.txt``)."""
    edges = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            w = float(parts[2]) if (weighted and len(parts) > 2) else 1.0
            edges.append((parts[0], parts[1], w))
    return from_edges(edges, undirected=undirected)


def save_edgelist(path: str, edges: Sequence[Tuple[str, str]]) -> None:
    with open(path, "w") as f:
        for s, d in edges:
            f.write(f"{s} {d}\n")
