"""Graph-embedding pretraining of the port (reference
``kon/model/embedding/``; counterpart of ``ml_function_tpu/embedding_pretrain``):
DeepWalk / node2vec / LINE / SDNE with vectorized walkers (numpy or the C++
engine), alias sampling, and a PyTorch skip-gram word2vec (no gensim); the
trainers run on the card unless given ``device='cpu'``."""

from .alias import alias_sample, build_alias, simulate
from .api import (DeepWalk, Line, Node2Vec, SDNE, model_test,
                  pre_weight_from_embeddings)
from .graph import CSRGraph, from_edges, read_edgelist, save_edgelist
from .walks import deepwalk_walks, node2vec_walks, walks_to_skipgram_pairs
from .word2vec import Word2VecConfig, train_word2vec

__all__ = ["DeepWalk", "Node2Vec", "Line", "SDNE", "model_test",
           "CSRGraph", "from_edges", "read_edgelist", "save_edgelist",
           "deepwalk_walks", "node2vec_walks", "walks_to_skipgram_pairs",
           "train_word2vec", "Word2VecConfig", "build_alias", "alias_sample",
           "simulate", "pre_weight_from_embeddings"]
