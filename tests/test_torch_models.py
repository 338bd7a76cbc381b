"""Model and block parity: the port (ml_function_tpu_torch) against the JAX
package on the CPU, with the JAX parameters copied across by key path.

Both packages round matmul inputs to bf16 at the same sites and sum in f32,
so outputs differ only by the f32 summation order (about 1e-7 relative):
rtol 1e-5 with atol 1e-5·max|ref| holds that with room and still catches a
missed or extra bf16 rounding (about 4e-3 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops import core as jcore
from ml_function_tpu.ops.base import bf16_matmul as jax_bf16_matmul
from ml_function_tpu.ops.interactions import fm_interaction as jax_fm
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.schema import (FeatureSet, SparseSpec,
                                                   criteo_feature_set)
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import MODEL_REGISTRY, get_model
from ml_function_tpu_torch.ops import attention as tattention
from ml_function_tpu_torch.ops import core as tcore
from ml_function_tpu_torch.ops.base import bf16_matmul, init_parameters
from ml_function_tpu_torch.ops.embedding import FusedEmbedding, RowTape, row_tape
from ml_function_tpu_torch.ops.interactions import fm_interaction
from ml_function_tpu_torch.serving import ShardedScorer

torch.set_num_threads(1)

RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("name,hp,batch", [
    ("deepfm", {"hidden": (16, 8)}, 256),
    ("xdeepfm", {"cin_hidden": (128,), "hidden": (16, 8)}, 256),    # CIN kernel route
    ("xdeepfm", {"cin_hidden": (128,), "hidden": (16, 8)}, 96),     # CIN einsum route
    ("xdeepfm", {"cin_hidden": (128,), "hidden": (16, 8),
                 "cin_kernel": "off"}, 256),
])
def test_model_logits_and_emb_l2_match_jax(name, hp, batch):
    fs, data = jax_make(n_rows=batch, n_dense=4, n_sparse=6, vocab_size=50,
                        embed_dim=4, seed=1)
    tfs, tdata = make_criteo_like(n_rows=batch, n_dense=4, n_sparse=6,
                                  vocab_size=50, embed_dim=4, seed=1)
    assert tfs.fingerprint == fs.fingerprint
    np.testing.assert_array_equal(tdata["sparse"], data["sparse"])

    jm = jax_get_model(name, fs, **hp)
    params, state = jm.init(jax.random.PRNGKey(0))
    want, _, want_aux = jm.apply(params, state, {"dense": data["dense"],
                                                 "sparse": data["sparse"]})
    tm = get_model(name, tfs, device="cpu", **hp)
    params_from_numpy(tm, _np_tree(params))
    with torch.no_grad():
        got, got_state, got_aux = tm({"dense": tdata["dense"],
                                      "sparse": tdata["sparse"]})
    assert got.shape == (batch,) and got_state == {}
    _close(got.numpy(), want)
    _close(got_aux["emb_l2"].numpy(), want_aux["emb_l2"])


@pytest.mark.parametrize("flag", ["0", "1"])
def test_autoint_logits_and_emb_l2_match_jax(flag, monkeypatch):
    """AutoInt at 6 fields (+ the dense pseudo-field), dim 4, 2 layers, on
    the small-L route (flag 0) and the field-attention route (flag 1), read
    at call time by both packages."""
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", flag)
    batch = 256
    fs, data = jax_make(n_rows=batch, n_dense=4, n_sparse=6, vocab_size=50,
                        embed_dim=4, seed=1)
    tfs, tdata = make_criteo_like(n_rows=batch, n_dense=4, n_sparse=6,
                                  vocab_size=50, embed_dim=4, seed=1)
    jm = jax_get_model("autoint", fs, n_layers=2)
    params, state = jm.init(jax.random.PRNGKey(0))
    want, _, want_aux = jm.apply(params, state, {"dense": data["dense"],
                                                 "sparse": data["sparse"]})
    tm = get_model("autoint", tfs, device="cpu", n_layers=2)
    params_from_numpy(tm, _np_tree(params))
    calls = []
    real = tattention.field_attention
    monkeypatch.setattr(tattention, "field_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        got, _, got_aux = tm({"dense": tdata["dense"], "sparse": tdata["sparse"]})
    assert calls == ([(batch, 7, 2, 16)] * 2 if flag == "1" else [])
    _close(got.numpy(), want)
    _close(got_aux["emb_l2"].numpy(), want_aux["emb_l2"])


def test_get_model_unknown_name_lists_registry():
    fs = criteo_feature_set([10] * 3, n_dense=2, embed_dim=4)
    with pytest.raises(KeyError, match="deepfm.*xdeepfm"):
        get_model("nope", fs, device="cpu")
    assert sorted(MODEL_REGISTRY) == [
        "afm", "autoint", "bst", "ccpm", "dcn", "deepcross", "deepfm", "deepmcp",
        "dicm", "dien", "din", "dlrm", "dmin", "dsin", "dssm", "dstn", "dts", "esmm",
        "fat_deepffm", "ffm", "fgcnn", "fibinet", "fignn", "flen", "fm", "fnn",
        "fwfm", "hpmn", "lr", "mimn", "mind", "mlr", "mmoe", "nfm", "oenn", "onn",
        "ple", "pnn", "seqfm", "sim", "wide_deep", "xdeepfm"]
    from ml_function_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
    assert sorted(MODEL_REGISTRY) == sorted(JAX_REGISTRY)


def test_get_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    fs = criteo_feature_set([10] * 3, n_dense=2, embed_dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("deepfm", fs)


def test_same_generator_seed_gives_same_weights():
    fs = criteo_feature_set([10] * 3, n_dense=2, embed_dim=4)
    a = get_model("xdeepfm", fs, device="cpu", cin_hidden=(8,), hidden=(4,),
                  generator=torch.Generator().manual_seed(5))
    b = get_model("xdeepfm", fs, device="cpu", cin_hidden=(8,), hidden=(4,),
                  generator=torch.Generator().manual_seed(5))
    for (ka, va), (kb, vb) in zip(a.named_parameters(), b.named_parameters()):
        assert ka == kb and torch.equal(va, vb)
    assert float(a.embedding.table.detach().std()) == pytest.approx(0.05, rel=0.2)


@pytest.mark.parametrize("activation,norm,res_every", [
    ("relu", None, 0), ("prelu", "layer", 1), ("dice", None, 2),
    ("sigmoid", "batch", 0), ("tanh", None, 1), ("gelu", "layer", 0),
    ("identity", "batch", 2),
])
def test_mlp_matches_jax(activation, norm, res_every):
    in_dim, hidden = 6, (8, 8, 5)
    jm = jcore.MLP(in_dim, hidden, activation=activation, res_every=res_every,
                   norm=norm, out_dim=1)
    params = _np_tree(jm.init(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(   # move scale/bias/alpha off their init
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(np.float32), params)
    state = _np_tree(jm.init_state())
    tm = tcore.MLP(in_dim, hidden, activation=activation, res_every=res_every,
                   norm=norm, out_dim=1)
    params_from_numpy(tm, params)
    x = rng.normal(0, 1, (32, in_dim)).astype(np.float32)
    for train in (False, True):
        want, new_state = jm(params, jnp.asarray(x), state=state, train=train)
        with torch.no_grad():
            got = tm(torch.from_numpy(x), train)
        _close(got.numpy(), want)
        for i, s in (new_state or {}).items():
            _close(getattr(tm, i).norm.mean.numpy(), s["mean"])
            _close(getattr(tm, i).norm.var.numpy(), s["var"])


def test_activation_rejects_unknown_kind():
    with pytest.raises(ValueError, match="swish"):
        tcore.Activation("swish", 4)


@pytest.mark.parametrize("f32", [False, True])
def test_bf16_matmul_matches_jax(f32, monkeypatch):
    if f32:
        monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 7, 33)).astype(np.float32)
    w = rng.normal(0, 1, (33, 9)).astype(np.float32)
    got = bf16_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32
    _close(got.numpy(), jax_bf16_matmul(jnp.asarray(x), jnp.asarray(w)))
    if not f32:   # rounded inputs: not the f32 product
        assert not np.allclose(got.numpy(), x @ w, rtol=1e-4, atol=0)


def test_fm_interaction_and_flatten_concat_match_jax():
    e = np.random.default_rng(4).normal(0, 1, (16, 5, 3)).astype(np.float32)
    _close(fm_interaction(torch.from_numpy(e)).numpy(), jax_fm(jnp.asarray(e)))
    d = np.ones((16, 2), np.float32)
    got = tcore.flatten_concat([torch.from_numpy(e), torch.from_numpy(d)])
    _close(got.numpy(), jcore.flatten_concat([jnp.asarray(e), jnp.asarray(d)]))


def test_fused_embedding_lookup_and_pre_weight():
    fs = criteo_feature_set([5, 7, 5], n_dense=0, embed_dim=3)
    fe = FusedEmbedding(fs)
    pre = {"C2": np.full((2, 3), 9.0, np.float32)}
    with torch.no_grad():
        init_parameters(fe, torch.Generator().manual_seed(0))
        fe.reset_parameters(torch.Generator().manual_seed(0), pre_weight=pre)
    ids = torch.tensor([[1, 0, 4], [0, 1, 2]])
    cross, lin = fe.sparse_all(ids)
    assert cross.shape == (2, 3, 3) and lin.shape == (2, 3)
    gids = ids + torch.tensor([0, 5, 12])
    assert torch.equal(cross, fe.table[gids])
    assert torch.equal(lin, fe.linear[gids][..., 0])
    assert torch.equal(fe.sparse(ids), cross)
    assert torch.equal(fe.sparse_linear(ids), lin)
    assert torch.all(cross[:, 1] == 9.0)   # C2 rows 0..1 come from pre_weight


def test_fused_embedding_without_a_table():
    """FFM's and LR's store: ``linear`` alone, the only state-dict key."""
    fs = criteo_feature_set([5, 7, 5], n_dense=0, embed_dim=3)
    fe = FusedEmbedding(fs, with_table=False)
    init_parameters(fe, torch.Generator().manual_seed(0))
    assert list(fe.state_dict()) == ["linear"] and fe.table is None
    ids = torch.tensor([[1, 0, 4], [0, 1, 2]])
    assert torch.equal(fe.sparse_linear(ids),
                       fe.linear[ids + torch.tensor([0, 5, 12])][..., 0])
    with pytest.raises(ValueError, match="pre_weight"):
        fe.reset_parameters(torch.Generator(), pre_weight={"C1": np.ones((1, 3))})
    with pytest.raises(ValueError, match="table, a linear or both"):
        FusedEmbedding(fs, with_linear=False, with_table=False)


def test_unported_routes_raise():
    """Every route of the reference now runs: the sharding context's
    sequence-sharded search and pipeline flags (item 8b) are accepted, and
    at a model group of 1 they leave the scores' bits as they are;
    row-sharded serving (item 8a) and the routes that came with the store
    (a mixed-width store, the cold-start hook, the RowTape) run:
    ``ShardedScorer`` on one rank gives ``Scorer``'s bits."""
    from ml_function_tpu_torch.parallel.context import sharded_embeddings
    from ml_function_tpu_torch.parallel.mesh import make_mesh
    from ml_function_tpu_torch.serving import Scorer
    fs = criteo_feature_set([5, 5], n_dense=1, embed_dim=4)
    m = get_model("deepfm", fs, device="cpu", hidden=(4,))
    rows = {"dense": np.zeros((5, 1), np.float32),
            "sparse": np.tile(np.arange(5, dtype=np.int32)[:, None], (1, 2))}
    want = Scorer(m, 4).predict_proba(rows)
    for flag in ({"seq_shard": True}, {"pp_microbatches": 2}):
        with sharded_embeddings(make_mesh(device="cpu"), **flag):
            np.testing.assert_array_equal(Scorer(m, 4).predict_proba(rows), want)
    np.testing.assert_array_equal(
        ShardedScorer(m, make_mesh(device="cpu"), batch_size=4).predict_proba(rows), want)
    mixed = FeatureSet(sparse=(SparseSpec("a", 5, dim=4),
                               SparseSpec("b", 5, dim=2)))
    assert {n for n, _ in FusedEmbedding(mixed).named_parameters()} == {
        "table", "linear", "table2", "linear2", "align2"}
    batch = {"dense": np.zeros((2, 1), np.float32),
             "sparse": np.ones((2, 2), np.int32),
             "emb_override": {"C1": np.zeros((2, 4), np.float32)}}
    with torch.no_grad():
        assert torch.isfinite(m(batch)[0]).all()
    with row_tape(RowTape("record")) as tape:
        m(batch)
    assert [g for g, _ in tape.records] == ["table", "linear"]
