"""Public pretraining API of the port, mirroring the reference's model
classes: ``DeepWalk/node2vec/Line/sdne(...).transform() -> {node: vec}``
(``kon/model/embedding/deepwalk.py:23-26``, ``node2vec.py:7-29``,
``line.py:8-173``, ``sdne.py:6-91``) and the ``model_test`` dispatcher
(``model_test.py:93-108``), with the defaults of
``ml_function_tpu/embedding_pretrain/api.py``. The walks run on the host
(the C++ engine or numpy), the trainers on ``device`` (default: the card).
Embeddings feed ``pre_weight`` warm-starts
(``FusedEmbedding.reset_parameters(generator, pre_weight=...)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from .._device import DeviceLike
from .graph import CSRGraph, read_edgelist
from .line import LineConfig, train_line
from .sdne import SDNEConfig, train_sdne
from .walks import deepwalk_walks, node2vec_walks, walks_to_skipgram_pairs
from .word2vec import Word2VecConfig, embeddings_to_dict, train_word2vec


def _use_native(engine: str) -> bool:
    """engine='auto'|'native'|'python' → whether to run the C++ walk engine
    (``native_walks.py``; multithreaded, statistically identical walks)."""
    if engine == "python":
        return False
    from . import native_walks
    if engine == "native":
        native_walks.get_lib()  # raise NativeBuildError loudly
        return True
    if engine != "auto":
        raise ValueError(f"engine {engine!r} not in ('auto','native','python')")
    return native_walks.native_available()


@dataclass
class DeepWalk:
    graph: CSRGraph
    num_walks: int = 80
    walk_length: int = 10
    window: int = 5
    dim: int = 64
    seed: int = 0
    engine: str = "auto"
    device: DeviceLike = None

    def transform(self) -> Dict[str, np.ndarray]:
        if _use_native(self.engine):
            from .native_walks import deepwalk_walks_native as walk_fn
        else:
            walk_fn = deepwalk_walks
        walks = walk_fn(self.graph, self.num_walks, self.walk_length,
                        self.seed)
        pairs = walks_to_skipgram_pairs(walks, self.window, self.seed)
        emb = train_word2vec(pairs, self.graph.num_nodes,
                             Word2VecConfig(dim=self.dim, seed=self.seed),
                             device=self.device)
        return embeddings_to_dict(emb, self.graph.node_names)


@dataclass
class Node2Vec:
    graph: CSRGraph
    num_walks: int = 80
    walk_length: int = 10
    p: float = 1.0
    q: float = 1.0
    window: int = 5
    dim: int = 64
    seed: int = 0
    engine: str = "auto"
    device: DeviceLike = None

    def transform(self) -> Dict[str, np.ndarray]:
        if _use_native(self.engine):
            from .native_walks import node2vec_walks_native as walk_fn
        else:
            walk_fn = node2vec_walks
        walks = walk_fn(self.graph, self.num_walks, self.walk_length,
                        p=self.p, q=self.q, seed=self.seed)
        pairs = walks_to_skipgram_pairs(walks, self.window, self.seed)
        emb = train_word2vec(pairs, self.graph.num_nodes,
                             Word2VecConfig(dim=self.dim, seed=self.seed),
                             device=self.device)
        return embeddings_to_dict(emb, self.graph.node_names)


@dataclass
class Line:
    graph: CSRGraph
    dim: int = 64
    order: str = "second"
    steps: int = 2000
    seed: int = 0
    device: DeviceLike = None

    def transform(self) -> Dict[str, np.ndarray]:
        emb = train_line(self.graph, LineConfig(dim=self.dim, order=self.order,
                                                steps=self.steps,
                                                seed=self.seed),
                         device=self.device)
        return embeddings_to_dict(emb, self.graph.node_names)


@dataclass
class SDNE:
    graph: CSRGraph
    hidden: tuple = (256, 128)
    epochs: int = 40
    seed: int = 0
    device: DeviceLike = None

    def transform(self) -> Dict[str, np.ndarray]:
        emb = train_sdne(self.graph, SDNEConfig(hidden=tuple(self.hidden),
                                                epochs=self.epochs,
                                                seed=self.seed),
                         device=self.device)
        return embeddings_to_dict(emb, self.graph.node_names)


def model_test(build_name: str, edgelist_path: str, **kw) -> Dict[str, np.ndarray]:
    """Dispatcher with the reference's canned names
    ('deepwalk'|'line'|'node2vec'|'sdne', model_test.py:93-108)."""
    g = read_edgelist(edgelist_path)
    name = build_name.lower()
    if name == "deepwalk":
        return DeepWalk(g, **kw).transform()
    if name == "node2vec":
        return Node2Vec(g, **kw).transform()
    if name == "line":
        return Line(g, **kw).transform()
    if name == "sdne":
        return SDNE(g, **kw).transform()
    raise ValueError(f"unknown embedding model {build_name!r}")


def pre_weight_from_embeddings(embs: Dict[str, np.ndarray],
                               vocab: Dict[str, int],
                               vocab_size: int) -> np.ndarray:
    """{name: vec} + feature vocab → (vocab_size, dim) matrix for
    ``FusedEmbedding.reset_parameters(generator, pre_weight={vocab_name:
    matrix})`` (the reference
    threads this through ``sparseFea.pre_weight``, data_prepare.py:168)."""
    dim = len(next(iter(embs.values())))
    out = np.zeros((vocab_size, dim), np.float32)
    for name, row in vocab.items():
        if name in embs and 0 <= row < vocab_size:
            out[row] = embs[name]
    return out
