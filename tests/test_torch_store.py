"""The rest of the embedding store: mixed widths (narrow sub-tables
``table{d}``/``linear{d}`` with their ``align{d}``) and int8 serving
storage, the port against the JAX package on the CPU.

Mixed widths take the cases of ``tests/test_mixed_width.py``: C1/C2 at
dim 8 over 12 ids, U1 at dim 4 over 50 ids and a narrow history of 6 over
U1's vocab. Lookups and a DeepFM step are held at 1e-6 (relative to the
largest) with ``ML_FUNCTION_TPU_F32_MATMUL=1`` and on the bf16 path (the
align product rounds its inputs to bf16 at the same site in both packages,
so the lookups agree to f32 rounding there too); gradients as
``tests/test_torch_match_image.py`` holds them.

int8: the packed bytes of ``quantize_table``/``quantize_fused`` equal
JAX's; the dequantised rows are q·2^e in both, so an int8 scorer's
probabilities equal the JAX int8 scorer's to f32 rounding (1e-6 with f32
matmuls); against the port's own f32 scorer they are within 0.02 and their
AUC within 2e-3 (``tests/test_serving.py``'s bars).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ml_function_tpu.features import schema as jschema
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops import embedding as jemb
from ml_function_tpu.serving import load_scorer as jax_load_scorer
from ml_function_tpu.train import loop as jloop
from ml_function_tpu.train import sparse as jsparse
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.schema import (DenseSpec, FeatureSet, SeqSpec,
                                                   SparseSpec)
from ml_function_tpu_torch.features.synthetic import (make_behavior_data,
                                                      make_criteo_like)
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import embedding as temb
from ml_function_tpu_torch.serving import export_model, load_scorer, quantize_for_serving
from ml_function_tpu_torch.train import loop as tloop
from ml_function_tpu_torch.train.optimizers import make_optimizer
from ml_function_tpu_torch.train.sparse import (RowAdagrad, create_sparse_train_state,
                                                make_sparse_train_step)

torch.set_num_threads(1)

BAR = 1e-6


def _close(got, want, rtol=BAR):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _mixed_fs(pkg, big_vocab=50, small_vocab=12, d0=8, dn=4):
    return pkg.FeatureSet(
        dense=(pkg.DenseSpec("I1"),),
        sparse=(pkg.SparseSpec("C1", small_vocab, dim=d0),
                pkg.SparseSpec("C2", small_vocab, dim=d0),
                pkg.SparseSpec("U1", big_vocab, vocab_name="u", dim=dn)),
        seq=(pkg.SeqSpec("hist_u", big_vocab, 6, vocab_name="u", dim=dn),))


class _Port:
    FeatureSet, DenseSpec, SparseSpec, SeqSpec = FeatureSet, DenseSpec, SparseSpec, SeqSpec


def _mixed_batch(n=32, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.uniform(0, 1, (n, 1)).astype(np.float32),
        "sparse": np.stack([rng.integers(1, 12, n), rng.integers(1, 12, n),
                            rng.integers(1, 50, n)], axis=1).astype(np.int32),
        "seq": {"hist_u": rng.integers(0, 50, (n, 6)).astype(np.int32)},
        "label": rng.integers(0, 2, n).astype(np.float32),
        "weight": np.ones(n, np.float32),
    }


def test_mixed_schema_matches_jax():
    fs, jfs = _mixed_fs(_Port), _mixed_fs(jschema)
    assert fs.fingerprint == jfs.fingerprint
    assert fs.mixed_width and fs.embed_dim == 8
    assert dict(fs.width_groups) == dict(jfs.width_groups) == {8: ("C1", "C2"), 4: ("u",)}
    assert fs.total_vocab == 24 and fs.aux_total_vocab(4) == 50
    assert fs.aux_vocab_offsets(4) == {"u": 0}


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_mixed_lookups_match_jax(f32, monkeypatch):
    """``sparse_all``, ``sparse``, ``sparse_linear`` and the narrow ``seq``
    from JAX's tables: the narrow column is its sub-table's row through
    ``align4``, in field order; pad rows of the narrow history are 0."""
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    jfs, fs = _mixed_fs(jschema), _mixed_fs(_Port)
    jfe = jemb.FusedEmbedding(jfs)
    params = jfe.init(jax.random.PRNGKey(0))
    fe = temb.FusedEmbedding(fs)
    assert {n: tuple(p.shape) for n, p in fe.named_parameters()} == {
        "table": (24, 8), "linear": (24, 1), "table4": (50, 4), "linear4": (50, 1),
        "align4": (4, 8)}
    params_from_numpy(fe, _np_tree(params))
    b = _mixed_batch()
    ids, tids = jnp.asarray(b["sparse"]), torch.tensor(b["sparse"])
    emb, lin = jfe.sparse_all(params, ids)
    temb_, tlin = fe.sparse_all(tids)
    _close(temb_.detach(), emb)
    _close(tlin.detach(), lin)
    _close(fe.sparse(tids).detach(), jfe.sparse(params, ids))
    _close(fe.sparse_linear(tids).detach(), jfe.sparse_linear(params, ids))
    rows, mask = jfe.seq(params, "hist_u", jnp.asarray(b["seq"]["hist_u"]))
    trows, tmask = fe.seq("hist_u", torch.tensor(b["seq"]["hist_u"]))
    _close(trows.detach(), rows)
    assert np.array_equal(tmask.numpy(), np.asarray(mask))
    assert not trows.detach().numpy()[~tmask.numpy()].any()
    with pytest.raises(ValueError, match="narrow"):
        fe.global_sparse_ids(tids)


def test_mixed_lookups_take_fused_gather_under_the_flag(monkeypatch):
    """As in the reference, a mixed-width store reads every width group,
    the primary one included, through ``_gather`` (the reference's
    ``_sparse_mixed`` → ``_keyed_rows`` → ``_rows``), so the merge-scatter
    flag sends each of its lookups to ``fused_gather``, the narrow
    sequence's too."""
    fs = _mixed_fs(_Port)
    fe = temb.FusedEmbedding(fs)
    from ml_function_tpu_torch.ops.base import init_parameters
    init_parameters(fe, torch.Generator().manual_seed(0))
    calls = []
    real = temb.fused_gather
    monkeypatch.setattr(temb, "_USE_MERGE_SCATTER", True)
    monkeypatch.setattr(temb, "fused_gather",
                        lambda t, i: calls.append((tuple(t.shape), i.shape[0])) or real(t, i))
    b = _mixed_batch()
    fe.sparse_all(torch.tensor(b["sparse"]))
    fe.seq("hist_u", torch.tensor(b["seq"]["hist_u"]))
    assert calls == [((50, 4), 32), ((50, 1), 32), ((24, 8), 64), ((24, 1), 64),
                     ((50, 4), 32 * 6)]


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_mixed_width_deepfm_step_matches_jax(f32, monkeypatch):
    """DeepFM on the mixed FeatureSet: logits, loss and every gradient (the
    narrow ``table4``, ``linear4`` and ``align4`` included), then one Adam
    step's parameters, against JAX."""
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    jfs, fs = _mixed_fs(jschema), _mixed_fs(_Port)
    jm = jax_get_model("deepfm", jfs, hidden=(16, 8))
    opt = optax.adam(1e-2)
    ts = jloop.create_train_state(jm, jax.random.PRNGKey(0), opt)
    b = _mixed_batch()
    (total, (logits, *_)), grads = jax.value_and_grad(
        lambda p: jloop.loss_fn(jm, p, {}, b, None), has_aux=True)(ts.params)
    ts2, _ = jloop.make_train_step(jm, opt, donate=False)(ts, b)
    tm = get_model("deepfm", fs, device="cpu", hidden=(16, 8))
    params_from_numpy(tm, _np_tree(ts.params))
    t_total, (t_logits, *_) = tloop.loss_fn(tm, tloop.to_device(b, "cpu"))
    t_total.backward()
    fwd_bar = BAR if f32 else 1e-4
    _close(t_logits.detach(), logits, fwd_bar)
    _close(t_total.item(), float(total), fwd_bar)
    want = _flat(grads)
    for n, p in tm.named_parameters():
        if f32:
            _close(p.grad.numpy(), want[n], BAR)
        else:
            err = np.abs(p.grad.numpy() - want[n])
            scale = float(np.abs(want[n]).max())
            assert (err <= 2.0 ** -8 * scale + 1e-3 * np.abs(want[n])).all(), n
    for key in ("table", "table4", "linear4", "align4"):
        assert getattr(tm.embedding, key).grad.abs().sum() > 0, key
    step = tloop.make_train_step(tm, make_optimizer("adam", 1e-2).init(tm))
    tm.zero_grad()
    step(b)
    got = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    for n, w in _flat(ts2.params).items():
        # Adam normalises each step: a gradient at f32 rounding moves a
        # parameter by up to its learning rate where the gradient is ~0
        np.testing.assert_allclose(got[n], w, rtol=0, atol=1e-6 if f32 else 1e-3,
                                   err_msg=n)


def test_mixed_width_sparse_row_path_matches_jax(monkeypatch):
    """The narrow sub-tables ride the RowTape (groups ``table4``,
    ``linear4``); ``align4`` stays with the dense optimizer; untouched rows
    never move; two RowAdagrad steps equal JAX's sparse steps."""
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    jfs, fs = _mixed_fs(jschema), _mixed_fs(_Port)
    jm = jax_get_model("deepfm", jfs, hidden=(16, 8))
    j_ts = jsparse.create_sparse_train_state(jm, jax.random.PRNGKey(0),
                                             optax.adam(1e-2), jsparse.RowAdagrad(0.05))
    j_step = jsparse.make_sparse_train_step(jm, optax.adam(1e-2),
                                            jsparse.RowAdagrad(0.05), donate=False)
    tm = get_model("deepfm", fs, device="cpu", hidden=(16, 8))
    params_from_numpy(tm, _np_tree(j_ts.params))
    ts = create_sparse_train_state(tm, make_optimizer("adam", 1e-2), RowAdagrad(0.05))
    assert set(ts.rows) == {"table", "linear", "table4", "linear4"}
    step = make_sparse_train_step(ts)
    t0 = tm.embedding.table4.detach().clone()
    batches = [_mixed_batch(seed=s) for s in (0, 1)]
    for b in batches:
        j_ts, j_out = j_step(j_ts, b)
        out = step(b)
        _close(out["loss"].item(), float(j_out["loss"]), 1e-5)
    touched = np.unique(np.concatenate([np.concatenate([b["sparse"][:, 2],
                                                        b["seq"]["hist_u"].reshape(-1)])
                                        for b in batches]))
    moved = (tm.embedding.table4.detach() - t0).abs().sum(1).numpy() > 0
    assert not moved[np.setdiff1d(np.arange(50), touched)].any()
    assert moved[np.unique(batches[0]["sparse"][:, 2])].all()
    got = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    for n, w in _flat(j_ts.params).items():
        np.testing.assert_allclose(got[n], w, rtol=1e-5, atol=1e-5, err_msg=n)


# ---------------------------------------------------------------------------
# int8 serving storage


def test_int8_packed_bytes_match_jax():
    """``quantize_table`` and ``quantize_fused`` give JAX's bytes, on rows
    of every scale, zero rows and ties of the rounding (x.5 steps, half to
    even in both), and rows whose max is 127·2^k. There, absmax/127 is
    exactly 2^k: ``torch.log2`` returns k, XLA's CPU ``log2`` returns k
    minus one f32 ulp at some k (2^-15 → -14.999999), so JAX takes the
    exponent k + 1 and the values q/2. Those rows, and only those, differ:
    each is checked to be such a row, with the port's exponent the exact
    ceil(log2) and its dequantised row the closer to the f32 one."""
    rng = np.random.default_rng(0)
    t = rng.normal(0, 1, (512, 9)).astype(np.float32) * np.exp2(
        rng.integers(-20, 8, (512, 1))).astype(np.float32)
    t[:16] = 0.0
    t[16:48, 0] = 127.0 * np.exp2(np.arange(-16, 16)).astype(np.float32)
    t[48:64] = np.float32(2.0 ** -3) * (np.arange(9) + 0.5)[None, :]
    lin = rng.normal(0, 0.05, (512, 1)).astype(np.float32)
    want = np.asarray(jemb.quantize_table(jnp.asarray(t))["qp"])
    got = temb.quantize_table(torch.tensor(t)).numpy()
    assert got.dtype == np.int8 and got.shape == (512, 10)
    differ = np.nonzero((got != want).any(axis=1))[0]
    assert set(differ) <= set(range(16, 48)) and len(differ) < 8, differ
    for r in differ:
        a = np.float32(np.abs(t[r]).max()) / np.float32(127.0)
        k = np.log2(np.float64(a))
        assert k == np.round(k), (r, a)                       # a power of 2
        assert float(jnp.log2(jnp.float32(a))) != k           # XLA's log2 misses it
        assert got[r, -1] == k and want[r, -1] == k + 1
        deq = [np.abs(q[r, :-1] * np.exp2(np.float64(q[r, -1])) - t[r]).max()
               for q in (got, want)]
        assert deq[0] <= deq[1], (r, deq)
    same = np.setdiff1d(np.arange(512), differ)
    np.testing.assert_array_equal(got[same], want[same])
    lin_p = torch.tensor(lin)
    np.testing.assert_array_equal(
        temb.quantize_fused(torch.tensor(t[64:, :8]), lin_p[64:]).numpy(),
        np.asarray(jemb.quantize_fused(jnp.asarray(t[64:, :8]), jnp.asarray(lin[64:]))["qpl"]))


def _auc(y, p):
    order = np.argsort(p, kind="stable")
    ranks = np.empty(len(p))
    ranks[order] = np.arange(1, len(p) + 1)
    pos = y > 0
    return (ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) / (pos.sum() * (~pos).sum())


@pytest.mark.parametrize("name,hp", [("deepfm", {"hidden": (16, 8)}), ("ffm", {}),
                                     ("din", {"hidden": (16, 8)})])
def test_int8_scorer_matches_jax_and_tracks_f32(name, hp, tmp_path, monkeypatch):
    """A model trained by the port, exported, and loaded with
    ``quantize='int8'`` by both packages: the same packed tables (DeepFM's
    (V, D+3) ``qpl``; FFM's ``ffm`` as ``[q·W, e]`` rows, its (V, 1)
    ``linear`` left f32; DIN's table without a linear as ``[q·D, e]``), the
    JAX int8 scorer's probabilities, and within 0.02 and an AUC within
    2e-3 of the port's f32 scorer; the int8 tables take under a third of
    the f32 bytes."""
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    if name == "din":
        fs, data = make_behavior_data(n_rows=512, n_items=40, n_cates=8, seq_len=8,
                                      embed_dim=8, seed=3)
    else:
        fs, data = make_criteo_like(n_rows=512, n_dense=2, n_sparse=4, vocab_size=50,
                                    embed_dim=8, seed=3)
    model = get_model(name, fs, device="cpu", **hp)
    tloop.fit(model, data, epochs=2, batch_size=128, learning_rate=1e-2, seed=0)
    hpj = {k: list(v) for k, v in hp.items()}
    export_model(str(tmp_path / "m"), name, fs, model, hyperparams=hpj)
    f32 = load_scorer(str(tmp_path / "m"), batch_size=128, device="cpu")
    q = load_scorer(str(tmp_path / "m"), batch_size=128, quantize="int8", device="cpu")
    jq = jax_load_scorer(str(tmp_path / "m"), batch_size=128, quantize="int8")
    emb = q.model.embedding
    assert not list(emb.named_parameters(recurse=False)) or name == "ffm"
    f32_bytes = sum(p.numel() * 4 for n, p in f32.model.named_parameters()
                    if n in ("embedding.table", "embedding.linear", "ffm"))
    if name == "deepfm":
        packed, want = emb.qpl, jq.params["embedding"]["qpl"]
    elif name == "ffm":
        packed, want = q.model.ffm.qp, jq.params["ffm"]["qp"]
        assert isinstance(emb.linear, torch.nn.Parameter)
        f32_bytes -= emb.linear.numel() * 4
    else:
        packed, want = emb.table.qp, jq.params["embedding"]["table"]["qp"]
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    assert packed.numel() * 3 < f32_bytes
    p_f, p_q, p_j = (s.predict_proba(data) for s in (f32, q, jq))
    np.testing.assert_allclose(p_q, p_j, rtol=0, atol=1e-6)
    assert float(np.abs(p_f - p_q).max()) < 0.02
    assert abs(_auc(data["label"], p_f) - _auc(data["label"], p_q)) < 2e-3


def test_int8_mixed_width_scorer_matches_jax(tmp_path, monkeypatch):
    """A mixed-width DeepFM in int8: the primary pair packs into ``qpl``, the
    narrow ``table4`` into ``[q·4, e]`` rows, ``linear4`` and ``align4``
    stay f32; scores equal the JAX int8 scorer's."""
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    fs = _mixed_fs(_Port)
    model = get_model("deepfm", fs, device="cpu", hidden=(16, 8),
                      generator=torch.Generator().manual_seed(3))
    export_model(str(tmp_path / "m"), "deepfm", fs, model, hyperparams={"hidden": [16, 8]})
    q = load_scorer(str(tmp_path / "m"), batch_size=16, quantize="int8", device="cpu")
    jq = jax_load_scorer(str(tmp_path / "m"), batch_size=16, quantize="int8")
    emb = q.model.embedding
    assert sorted(n for n, _ in emb.named_parameters()) == ["align4", "linear4"]
    np.testing.assert_array_equal(emb.table4.qp.numpy(),
                                  np.asarray(jq.params["embedding"]["table4"]["qp"]))
    np.testing.assert_array_equal(emb.qpl.numpy(), np.asarray(jq.params["embedding"]["qpl"]))
    data = {k: v for k, v in _mixed_batch().items() if k not in ("label", "weight")}
    np.testing.assert_allclose(q.predict_proba(data), jq.predict_proba(data), rtol=0,
                               atol=1e-6)


def test_an_int8_model_refuses_to_train():
    fs, data = make_criteo_like(n_rows=64, n_dense=2, n_sparse=3, vocab_size=9,
                                embed_dim=4, seed=0)
    model = quantize_for_serving(get_model("deepfm", fs, device="cpu", hidden=(4,)))
    assert temb.has_int8_tables(model)
    with pytest.raises(ValueError, match="int8"):
        tloop.make_train_step(model, make_optimizer("adam", 1e-3).init(model))
    with pytest.raises(ValueError, match="int8"):
        create_sparse_train_state(model, make_optimizer("adam", 1e-3), RowAdagrad())
    with torch.no_grad():
        assert torch.isfinite(model(data)[0]).all()
