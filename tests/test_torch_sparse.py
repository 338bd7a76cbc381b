"""The sparse-row path (``train/sparse.py``): ``dedup_sum``, the row
optimizers and the sparse step, the port against its own dense path and
against the JAX package's sparse step on the CPU, the cases of
``tests/test_sparse_optimizer.py`` with the JAX weights carried across by
the bridge.

Bars: the JAX test's ``atol=1e-5, rtol=1e-5`` on every parameter after the
steps, with ``ML_FUNCTION_TPU_F32_MATMUL=1`` in both packages (on the bf16
path an f32 difference of one ulp can round a tower's weight gradient one
bf16 step apart, ``ROADMAP.md`` R3, which the steps carry past 1e-5); the
losses at ``rtol=1e-5``; ``dedup_sum`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ml_function_tpu.features.synthetic import make_behavior_data as jax_make_behavior
from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.train import sparse as jsparse
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_behavior_data, make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import embedding as temb
from ml_function_tpu_torch.ops.kernels import embedding_grad as teg
from ml_function_tpu_torch.train import loop as tloop
from ml_function_tpu_torch.train.optimizers import make_optimizer
from ml_function_tpu_torch.train.sparse import (RowAdagrad, RowAdam, aux_row_tables,
                                                create_sparse_train_state, dedup_sum,
                                                make_row_optimizer,
                                                make_sparse_train_step,
                                                row_table_groups, sparse_dense_tree)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _f32(monkeypatch):
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _params_close(model, want):
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n, w in want.items():
        np.testing.assert_allclose(got[n], w, err_msg=n, **TOL)


@pytest.mark.parametrize("case", ["reference", "random"])
def test_dedup_sum_matches_jax(case):
    """Sorted ids, each run's sum on its last slot, zeros elsewhere, and
    ``is_end``: the JAX function's outputs exactly (sums of integers)."""
    if case == "reference":
        gids = np.asarray([5, 2, 5, 5, 9, 2])
        g = np.arange(12, dtype=np.float32).reshape(6, 2)
    else:
        rng = np.random.default_rng(0)
        gids = rng.integers(0, 40, 300)
        g = rng.integers(-8, 8, (300, 3)).astype(np.float32)
    want = jsparse.dedup_sum(jnp.asarray(gids), jnp.asarray(g))
    got = dedup_sum(torch.tensor(gids), torch.tensor(g))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _criteo(**kw):
    return jax_make(**kw), make_criteo_like(**kw)


def _runs(name, hp, kw, dense, row_opt, lr, n_batches=3, same_batch=False,
          make=(jax_make, make_criteo_like)):
    """The port's sparse steps, its dense steps and the JAX sparse steps
    from the JAX weights; returns (port sparse model, port dense model,
    JAX params, the three runs' losses)."""
    jfs, jdata = make[0](**kw)
    fs, data = make[1](**kw)
    jm = jax_get_model(name, jfs, **hp)
    jopt = {"adagrad": optax.adagrad, "adam": optax.adam}[dense](lr)
    jrow = {"adagrad": jsparse.RowAdagrad, "adam": jsparse.RowAdam}[dense](learning_rate=lr)
    j_ts = jsparse.create_sparse_train_state(jm, jax.random.PRNGKey(0), jopt, jrow)
    j_step = jsparse.make_sparse_train_step(jm, jopt, jrow, donate=False)
    batches = list(tloop.iter_batches(data, 32))[:n_batches]
    if same_batch:
        batches = [batches[0]] * 4
    models = []
    for _ in range(2):
        m = get_model(name, fs, device="cpu", **hp)
        params_from_numpy(m, _np_tree(j_ts.params))
        models.append(m)
    sparse_m, dense_m = models
    ts = create_sparse_train_state(sparse_m, make_optimizer(dense, lr), row_opt)
    s_step = make_sparse_train_step(ts)
    d_step = tloop.make_train_step(dense_m, make_optimizer(dense, lr).init(dense_m))
    losses = []
    for b in batches:
        j_ts, j_out = j_step(j_ts, b)
        losses.append((s_step(b)["loss"].item(), d_step(b)["loss"].item(),
                       float(j_out["loss"])))
    return sparse_m, dense_m, _flat(j_ts.params), losses, ts


def _check(sparse_m, dense_m, jax_params, losses):
    for s, d, j in losses:
        np.testing.assert_allclose(s, d, rtol=1e-5)
        np.testing.assert_allclose(s, j, rtol=1e-5)
    _params_close(sparse_m, jax_params)
    _params_close(sparse_m, {n: p.detach().numpy() for n, p in dense_m.named_parameters()})


def test_sparse_adagrad_matches_dense_and_jax_multistep():
    """3 RowAdagrad steps of DeepFM (ids repeat within a batch) equal 3 dense
    Adagrad steps of the port and 3 JAX sparse steps; the dense optimizer
    holds no (V, ·) state."""
    kw = dict(n_rows=96, n_dense=2, n_sparse=4, vocab_size=11, embed_dim=4, seed=0)
    s, d, j, losses, ts = _runs("deepfm", {"hidden": (8,)}, kw, "adagrad",
                                RowAdagrad(learning_rate=0.05), 0.05)
    _check(s, d, j, losses)
    v = s.feature_set.total_vocab
    assert set(ts.rows) == {"table", "linear"}
    held = [t for st in ts.dense.state.values() for t in st.values()]
    assert held and not any(t.dim() == 2 and t.shape[0] == v for t in held)
    names = {n for n, _ in sparse_dense_tree(s)}
    assert "embedding.table" not in names and "mlp.head.w" in names


def test_sparse_lazy_adam_matches_dense_when_all_rows_touched():
    """The same batch every step touches the same rows: lazy Adam equals
    dense Adam (touched rows alike, the others still in both)."""
    kw = dict(n_rows=32, n_dense=2, n_sparse=3, vocab_size=9, embed_dim=4, seed=1)
    s, d, j, losses, ts = _runs("fm", {}, kw, "adam", RowAdam(learning_rate=1e-2), 1e-2,
                                same_batch=True)
    _check(s, d, j, losses)
    assert set(ts.rows["table"]) == {"m", "v", "t"}
    assert ts.rows["table"]["t"].dtype == torch.int32


def test_sparse_untouched_rows_and_moments_stay_put():
    kw = dict(n_rows=32, n_dense=0, n_sparse=3, vocab_size=50, embed_dim=4, seed=2)
    fs, data = make_criteo_like(**kw)
    model = get_model("fm", fs, device="cpu")
    ts = create_sparse_train_state(model, make_optimizer("adagrad", 0.1),
                                   RowAdagrad(learning_rate=0.1))
    b = next(tloop.iter_batches(data, 32))
    offs = fs.sparse_offsets()
    touched = sorted({int(i) for f in range(3) for i in b["sparse"][:, f] + offs[f]})
    before = model.embedding.table.detach().clone()
    make_sparse_train_step(ts)(b)
    after = model.embedding.table.detach()
    acc = ts.rows["table"]["acc"]
    untouched = sorted(set(range(fs.total_vocab)) - set(touched))
    assert untouched
    assert torch.equal(after[untouched], before[untouched])
    assert torch.equal(acc[untouched], torch.full_like(acc[untouched], 0.1))
    assert (after[touched] - before[touched]).abs().max() > 0


def test_sparse_rowwise_adagrad_single_accumulator_learns():
    fs, data = make_criteo_like(n_rows=512, n_dense=2, n_sparse=4, vocab_size=13,
                                embed_dim=4, seed=3)
    model = get_model("deepfm", fs, device="cpu", hidden=(8,))
    ts = create_sparse_train_state(model, make_optimizer("adam", 5e-3),
                                   make_row_optimizer("adagrad", 0.1, rowwise=True))
    assert ts.rows["table"]["acc"].shape == (fs.total_vocab, 1)
    step = make_sparse_train_step(ts)
    losses = [step(b)["loss"].item() for epoch in range(3)
              for b in tloop.iter_batches(data, 128, shuffle=True, seed=epoch)]
    assert np.mean(losses[-4:]) < np.mean(losses[:4]), losses
    assert ts.step == len(losses)
    with pytest.raises(ValueError, match="unknown row optimizer"):
        make_row_optimizer("sgd")


def test_sparse_step_supports_sequence_models():
    """DIN: the histories' lookups reach the row update; equal to the dense
    step and the JAX sparse step."""
    kw = dict(n_rows=64, n_items=20, n_cates=6, seq_len=8, vocab_size=11,
              embed_dim=4, seed=4)
    s, d, j, losses, _ = _runs("din", {"hidden": (8,)}, kw, "adagrad",
                               RowAdagrad(learning_rate=0.05), 0.05, n_batches=1,
                               make=(jax_make_behavior, make_behavior_data))
    _check(s, d, j, losses)


@pytest.mark.parametrize("name", ["ffm", "onn", "oenn"])
def test_sparse_step_supports_aux_table_models(name):
    """FFM's (V, F·K) blocks, ONN's, OENN's per-order tables ride the tape
    under their own keys, with their own row states."""
    kw = dict(n_rows=96, n_dense=2, n_sparse=3, vocab_size=9, embed_dim=4, seed=5)
    hp = {} if name == "ffm" else {"hidden": (8,)}
    s, d, j, losses, ts = _runs(name, hp, kw, "adagrad", RowAdagrad(learning_rate=0.05),
                                0.05)
    _check(s, d, j, losses)
    aux = set(aux_row_tables(s))
    assert aux and aux <= set(ts.rows)
    assert set(row_table_groups(s)) == set(ts.rows)


def test_no_kernel_under_a_tape_with_the_merge_scatter_flag(monkeypatch):
    """With the merge-scatter flag's attribute set, a DIN sparse step reads
    every row from the tape: ``fused_gather`` (whose backward is the K1
    kernel) is never called and K1's count stays 0, where the dense step
    calls it for the two histories."""
    fs, data = make_behavior_data(n_rows=64, n_items=20, n_cates=6, seq_len=8,
                                  embed_dim=4, seed=4)
    monkeypatch.setattr(temb, "_USE_MERGE_SCATTER", True)
    calls = []
    real = temb.fused_gather
    monkeypatch.setattr(temb, "fused_gather", lambda t, i: calls.append(1) or real(t, i))
    teg.merge_scatter_launches = 0
    model = get_model("din", fs, device="cpu", hidden=(8,))
    ts = create_sparse_train_state(model, make_optimizer("adagrad", 0.05), RowAdagrad(0.05))
    b = next(tloop.iter_batches(data, 32))
    make_sparse_train_step(ts)(b)
    assert calls == [] and teg.merge_scatter_launches == 0
    tloop.make_train_step(model, make_optimizer("adagrad", 0.05).init(model))(b)
    assert len(calls) == 2


def test_row_tape_modes_and_nesting():
    """Record returns zeros of the lookup's shape and logs (group, ids);
    inject returns the given rows in order and checks their shape; two
    tapes of one mode do not nest on a thread."""
    rec = temb.RowTape("record")
    ids = torch.tensor([[1, 2], [3, 4]])
    with temb.row_tape(rec):
        assert temb.active_row_tape() is rec
        z = temb.gather_rows(torch.ones(9, 3), ids, tape_key="ffm")
        with pytest.raises(AssertionError, match="already active"):
            temb.row_tape(temb.RowTape("record")).__enter__()
    assert temb.active_row_tape() is None
    assert torch.equal(z, torch.zeros(2, 2, 3)) and rec.records[0][0] == "ffm"
    rows = torch.arange(12.0).reshape(2, 2, 3)
    with temb.row_tape(temb.RowTape("inject", [rows, rows])):
        assert temb.gather_rows(torch.ones(9, 3), ids, tape_key="ffm") is rows
        with pytest.raises(AssertionError, match="out of sync"):
            temb.gather_rows(torch.ones(9, 5), ids, tape_key="ffm")
    assert torch.equal(temb.gather_rows(torch.arange(27.0).reshape(9, 3), ids),
                       torch.arange(27.0).reshape(9, 3)[ids])


def _sim_fs_data(n=16, L=12):
    from ml_function_tpu_torch.features.schema import SeqSpec
    fs, data = make_behavior_data(n_rows=n, n_items=20, n_cates=6, seq_len=6,
                                  embed_dim=4, seed=6)
    fs = fs.replace(seq=fs.seq + (SeqSpec("hist_long", 21, L, vocab_name="item", dim=4),))
    rng = np.random.default_rng(6)
    data["seq"]["hist_long"] = rng.integers(0, 21, (n, L)).astype(np.int32)
    return fs, data


def test_sim_soft_search_under_a_tape_scores_as_without():
    """Under a RowTape SIM's soft search selects from the whole stream's
    looked-up rows; injected with the table's own rows it gives the
    scores of the normal forward. SIM's table lives inside its DIEN core,
    which the sparse step (as the reference's) does not take."""
    fs, data = _sim_fs_data()
    model = get_model("sim", fs, device="cpu", hidden=(8,), long_behavior=("hist_long",),
                      top_k=4)
    with torch.no_grad():
        want = model(data)[0]
        rec = temb.RowTape("record")
        with temb.row_tape(rec):
            model(data)
        table = model.dien.embedding.table
        rows = [table[g] for _, g in rec.records]
        with temb.row_tape(temb.RowTape("inject", rows)):
            got = model(data)[0]
    assert {g for g, _ in rec.records} == {"table"}
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    ts = create_sparse_train_state(model, make_optimizer("adam", 1e-3), RowAdagrad())
    with pytest.raises(ValueError, match="unknown group 'table'"):
        make_sparse_train_step(ts)(dict(data, label=data["label"]))
