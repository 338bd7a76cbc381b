"""Graph-embedding pretraining of the port (``embedding_pretrain/``) against
the JAX package's.

The numpy modules (graph, alias, walks, evaluate) are copies: their arrays
equal the JAX package's bit for bit for the same seed. The trainers start
from the JAX package's initial tables or parameters (bridged) and, for
word2vec, replay the JAX package's key chain for the negatives; LINE's and
SDNE's batches come from the same numpy generator in both packages. Bars,
each beside its reason (f32 matmuls on both sides):
- LINE, 60 SGD steps: within 1e-5 (updates linear in the gradients; the
  duplicate ids' gradients are summed in another order);
- word2vec, 6 epochs of Adam with the plateau and early-stop callbacks, and
  SDNE, 4 epochs of Adam: within 1e-5 (Adam divides by √v, which magnifies
  the rounding of near-zero gradients; the callbacks' decisions must
  match; 1.8e-7 and 3.5e-6 measured, SDNE's embeddings reaching 1.46).
The port's own draws are held to the JAX tests' community-separation bars
(DeepWalk above 0.3, LINE above 0.2).
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import ml_function_tpu.embedding_pretrain as jep
from ml_function_tpu.embedding_pretrain import line as jline
from ml_function_tpu.embedding_pretrain import sdne as jsdne
from ml_function_tpu.embedding_pretrain import word2vec as jw2v
from ml_function_tpu.embedding_pretrain.alias import FlatAliasTables as JFlat
from ml_function_tpu.embedding_pretrain.evaluate import cosine_class_gap as jgap
from ml_function_tpu.embedding_pretrain.evaluate import read_labels as jread_labels
from ml_function_tpu.ops.base import normal_init as jax_normal_init
from ml_function_tpu.ops.base import split_rngs
from ml_function_tpu.ops.core import MLP as JMLP
from ml_function_tpu.tools import feature_tool as jft
import ml_function_tpu_torch.embedding_pretrain as tep
from ml_function_tpu_torch.embedding_pretrain import line as tline
from ml_function_tpu_torch.embedding_pretrain import sdne as tsdne
from ml_function_tpu_torch.embedding_pretrain import word2vec as tw2v
from ml_function_tpu_torch.embedding_pretrain.alias import FlatAliasTables
from ml_function_tpu_torch.embedding_pretrain.evaluate import cosine_class_gap, read_labels
from ml_function_tpu_torch.features.schema import FeatureSet, SparseSpec
from ml_function_tpu_torch.ops.embedding import FusedEmbedding
from ml_function_tpu_torch.tools import feature_tool as tft

torch.set_num_threads(1)

W2V_CFG = dict(dim=8, epochs=6, min_steps=0, batch_size=128, learning_rate=0.01,
               patience=2, plateau_factor=0.5, plateau_patience=1, seed=0)
LINE_CFG = dict(dim=16, order="all", steps=60, batch_size=64, seed=0)
SDNE_CFG = dict(hidden=(32, 8), epochs=4, batch_size=4, seed=0)


@pytest.fixture(scope="module", autouse=True)
def _f32():
    old = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    yield
    if old is None:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    else:
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = old


def two_cliques(from_edges, k=8):
    """Two k-cliques joined by one bridge edge (the JAX tests' graph)."""
    edges = []
    for base in (0, k):
        for i in range(k):
            for j in range(k):
                if i != j:
                    edges.append((f"n{base+i}", f"n{base+j}", 1.0))
    edges.append((f"n{k-1}", f"n{k}", 1.0))
    edges.append((f"n{k}", f"n{k-1}", 1.0))
    return from_edges(edges)


def intra_inter_ratio(embs, k=8):
    names = sorted(embs, key=lambda s: int(s[1:]))
    mat = np.stack([embs[n] for n in names])
    mat = mat / (np.linalg.norm(mat, axis=1, keepdims=True) + 1e-9)
    sim = mat @ mat.T
    intra = (sim[:k, :k].sum() - k) / (k * k - k)
    intra += (sim[k:, k:].sum() - k) / (k * k - k)
    inter = sim[:k, k:].mean() * 2
    return intra - inter


def _w2v_pairs():
    rng = np.random.default_rng(0)
    pairs = [rng.integers(lo, hi, 2) for lo, hi in ((0, 8), (8, 16)) for _ in range(400)]
    return np.asarray(pairs, np.int32)


def _behavior_frame():
    rng = np.random.default_rng(4)
    n = 120
    return pd.DataFrame({"user": rng.integers(0, 12, n), "item": rng.integers(0, 15, n),
                         "ts": rng.permutation(n),
                         "s": ["|".join(f"t{v}" for v in rng.integers(0, 9, rng.integers(1, 5)))
                               for _ in range(n)]})


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's trainers and their initial state, on the two-clique
    graph."""
    out = {}
    g = two_cliques(jep.from_edges)
    # word2vec: the tables train_word2vec draws, and its run
    pairs = _w2v_pairs()
    r1, r2 = jax.random.split(jax.random.PRNGKey(W2V_CFG["seed"]))
    out["w2v_init"] = (np.asarray(jax_normal_init(r1, (16, 8), 0.5 / 8)),
                       np.zeros((16, 8), np.float32))
    out["w2v_key"] = r2
    out["w2v"] = jw2v.train_word2vec(pairs, 16, jw2v.Word2VecConfig(**W2V_CFG))
    # LINE
    k1, _ = jax.random.split(jax.random.PRNGKey(LINE_CFG["seed"]))
    out["line_init"] = (np.asarray(jax_normal_init(k1, (g.num_nodes, 16), 0.5 / 16)),
                        np.zeros((g.num_nodes, 16), np.float32))
    out["line"] = jline.train_line(g, jline.LineConfig(**LINE_CFG))
    # SDNE
    n, hidden = g.num_nodes, SDNE_CFG["hidden"]
    rngs = split_rngs(jax.random.PRNGKey(SDNE_CFG["seed"]), ["enc", "dec"])
    out["sdne_init"] = jax.tree_util.tree_map(np.asarray, {
        "enc": JMLP(n, hidden, activation="relu").init(rngs["enc"]),
        "dec": JMLP(hidden[-1], tuple(reversed(hidden[:-1])) + (n,),
                    activation="relu").init(rngs["dec"])})
    out["sdne"] = jsdne.train_sdne(g, jsdne.SDNEConfig(**SDNE_CFG))
    df = _behavior_frame()
    out["items"] = jft.item_embeddings_from_sequences(df, "user", "item", "ts", dim=4,
                                                      num_walks=3, walk_length=5)
    out["aggregates"] = jft.seq_embedding_aggregates(df, "s", dim=4)
    return out


def _replay(key):
    """The negatives' slots that the JAX trainer draws, step by step: one
    split of the key chain a step, then ``randint`` over the noise table."""
    state = {"key": key}

    def sampler(b, k):
        state["key"], nk = jax.random.split(state["key"])
        return np.array(jax.random.randint(nk, (b, k), 0, 1 << 20))

    return sampler


# ---------------------------------------------------------------------------
# the copied numpy modules, bit for bit


def test_graph_matches_jax(tmp_path):
    """CSR graphs (directed and undirected), edgelist io and degrees."""
    rng = np.random.default_rng(1)
    edges = [(f"v{s}", f"v{d}", float(w)) for s, d, w in
             zip(rng.integers(0, 30, 90), rng.integers(0, 30, 90), rng.uniform(1, 2, 90))]
    for und in (False, True):
        a, b = tep.from_edges(edges, undirected=und), jep.from_edges(edges, undirected=und)
        for f in ("indptr", "indices", "weights"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert a.node_names == b.node_names and a.name_to_id == b.name_to_id
        np.testing.assert_array_equal(a.out_weight_sums(), b.out_weight_sums())
    path = str(tmp_path / "g.txt")
    tep.save_edgelist(path, [(s, d) for s, d, _ in edges])
    a, b = tep.read_edgelist(path, undirected=True), jep.read_edgelist(path, undirected=True)
    np.testing.assert_array_equal(a.indices, b.indices)
    assert a.node_names == b.node_names


def test_alias_matches_jax():
    probs = np.random.default_rng(2).uniform(size=13)
    for x, y in zip(tep.build_alias(probs), jep.build_alias(probs)):
        np.testing.assert_array_equal(x, y)
    acc, al = tep.build_alias(probs)
    np.testing.assert_array_equal(
        tep.alias_sample(acc, al, np.random.default_rng(5), size=(40, 3)),
        jep.alias_sample(acc, al, np.random.default_rng(5), size=(40, 3)))
    tables = [tep.build_alias(np.arange(1.0, n + 1)) for n in (1, 4, 7)]
    ids = np.random.default_rng(6).integers(0, 3, 50)
    np.testing.assert_array_equal(FlatAliasTables(tables).sample(ids, np.random.default_rng(7)),
                                  JFlat(tables).sample(ids, np.random.default_rng(7)))
    assert tep.simulate() == jep.simulate() < 0.01


def test_python_walks_and_pairs_match_jax():
    a, b = two_cliques(tep.from_edges, 4), two_cliques(jep.from_edges, 4)
    np.testing.assert_array_equal(tep.deepwalk_walks(a, 3, 6, seed=1),
                                  jep.deepwalk_walks(b, 3, 6, seed=1))
    w = tep.node2vec_walks(a, 2, 5, p=0.5, q=2.0, seed=2)
    np.testing.assert_array_equal(w, jep.node2vec_walks(b, 2, 5, p=0.5, q=2.0, seed=2))
    np.testing.assert_array_equal(tep.walks_to_skipgram_pairs(w, 3, seed=4),
                                  jep.walks_to_skipgram_pairs(w, 3, seed=4))


def test_evaluate_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    embs = {f"n{i}": rng.normal(size=4).astype(np.float32) for i in range(12)}
    labels = {f"n{i}": i % 3 for i in range(12)}
    assert cosine_class_gap(embs, labels) == jgap(embs, labels)
    path = tmp_path / "labels.txt"
    path.write_text("".join(f"{k} {v}\n" for k, v in labels.items()))
    assert read_labels(str(path)) == jread_labels(str(path)) == labels


# ---------------------------------------------------------------------------
# the trainers from the JAX package's state


def test_word2vec_matches_jax_with_replayed_draws(jax_side):
    """Six epochs at batch 128 with ReduceLROnPlateau, early stopping and
    keep-best, from the JAX tables and the JAX key chain's negatives."""
    got = tw2v.train_word2vec(_w2v_pairs(), 16, tw2v.Word2VecConfig(**W2V_CFG),
                              init=jax_side["w2v_init"], sampler=_replay(jax_side["w2v_key"]),
                              device="cpu")
    np.testing.assert_allclose(got, jax_side["w2v"], rtol=1e-5, atol=1e-5)


def test_line_matches_jax(jax_side):
    g = two_cliques(tep.from_edges)
    got = tline.train_line(g, tline.LineConfig(**LINE_CFG), init=jax_side["line_init"],
                           device="cpu")
    np.testing.assert_allclose(got, jax_side["line"], rtol=1e-5, atol=1e-5)


def test_sdne_matches_jax(jax_side):
    g = two_cliques(tep.from_edges)
    got = tsdne.train_sdne(g, tsdne.SDNEConfig(**SDNE_CFG), init=jax_side["sdne_init"],
                           device="cpu")
    assert got.shape == (g.num_nodes, 8)
    np.testing.assert_allclose(got, jax_side["sdne"], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the port's own draws


def test_deepwalk_and_line_separate_communities():
    """The JAX tests' bars, from the port's generators (and the native
    walks where g++ builds them)."""
    g = two_cliques(tep.from_edges)
    embs = tep.DeepWalk(g, num_walks=30, walk_length=8, window=3, dim=16, seed=0,
                        device="cpu").transform()
    assert intra_inter_ratio(embs) > 0.3
    embs = tep.Line(g, dim=16, order="all", steps=400, seed=0, device="cpu").transform()
    assert intra_inter_ratio(embs) > 0.2
    embs = tep.SDNE(g, hidden=(32, 8), epochs=10, seed=0, device="cpu").transform()
    assert len(embs) == g.num_nodes and next(iter(embs.values())).shape == (8,)
    node2vec = tep.Node2Vec(g, num_walks=4, walk_length=6, p=0.5, q=2.0, dim=8,
                            engine="python", device="cpu").transform()
    assert sorted(node2vec) == sorted(g.node_names)


def test_model_test_dispatch_and_default_device(tmp_path):
    path = str(tmp_path / "edges.txt")
    tep.save_edgelist(path, [("a", "b"), ("b", "c"), ("c", "a")])
    embs = tep.model_test("line", path, dim=4, steps=3, device="cpu")
    assert sorted(embs) == ["a", "b", "c"]
    with pytest.raises(ValueError, match="unknown embedding model"):
        tep.model_test("gcn", path)
    with pytest.raises(ValueError, match="engine"):
        tep.DeepWalk(tep.read_edgelist(path), engine="gpu", device="cpu").transform()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tep.Line(tep.read_edgelist(path), steps=1).transform()


def test_pre_weight_into_fused_embedding():
    """``pre_weight_from_embeddings`` (the JAX package's matrix) warm-starts
    a FusedEmbedding's vocab block."""
    embs = {"a": np.ones(4, np.float32), "b": 2 * np.ones(4, np.float32), "z": np.zeros(4)}
    vocab = {"a": 1, "b": 2, "zz": 3}
    w = tep.pre_weight_from_embeddings(embs, vocab, vocab_size=5)
    np.testing.assert_array_equal(w, jep.pre_weight_from_embeddings(embs, vocab, 5))
    assert (w[1] == 1).all() and (w[2] == 2).all() and (w[0] == 0).all() and (w[3] == 0).all()
    fs = FeatureSet(sparse=(SparseSpec("x", 4, vocab_name="v", dim=4),
                            SparseSpec("item", 5, dim=4)))
    fe = FusedEmbedding(fs)
    with torch.no_grad():
        fe.reset_parameters(torch.Generator().manual_seed(0), pre_weight={"item": w})
    off = fs.vocab_offsets["item"]
    np.testing.assert_array_equal(fe.table[off:off + 5].detach().numpy(), w)


def test_feature_tool_graph_functions_match_jax(jax_side):
    """The click-sequence edges equal the JAX package's; DeepWalk item
    embeddings cover the same items at the same width, and the word2vec
    aggregates have the same columns and index."""
    df = _behavior_frame()
    assert tft.user_item_edgelist(df, "user", "item", "ts") == \
        jft.user_item_edgelist(df, "user", "item", "ts")
    items = tft.item_embeddings_from_sequences(df, "user", "item", "ts", dim=4, num_walks=3,
                                               walk_length=5, device="cpu")
    assert sorted(items) == sorted(jax_side["items"])
    assert all(v.shape == (4,) and np.isfinite(v).all() for v in items.values())
    agg = tft.seq_embedding_aggregates(df, "s", dim=4, device="cpu")
    want = jax_side["aggregates"]
    assert list(agg.columns) == list(want.columns)
    assert agg.index.equals(want.index) and np.isfinite(agg.to_numpy()).all()
