"""The sparse-row step over row-sharded tables (``parallel/sparse.py``) on
gloo ranks, against the JAX package's single-device sparse step.

The cases of ``tests/test_parallel_sparse.py``: the port runs in 4 spawned
processes (one spawn for the file, ``torch_parallel_worker.sparse_cases``)
on a (2, 2) mesh, and a (1, 4) one for the a2a routing across four
owners; the JAX side runs here. Both start from the JAX parameters,
bridged, with ``ML_FUNCTION_TPU_F32_MATMUL=1``.

Bars, each beside its reason: the losses within rtol 1e-5 (the global BCE,
a sum of per-rank sums), the parameters after the steps within rtol 1e-4,
atol 1e-5 (the JAX test's: row gradients summed over ranks in another
order); the a2a routing against the allgather one within rtol 1e-5,
atol 1e-6 (the JAX test's); the bf16-compressed exchange's loss within
5e-2 of the exact one's (the JAX test's bar).
"""

import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from ml_function_tpu.features import synthetic as jsyn
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.train import loop as jloop
from ml_function_tpu.train import sparse as jsparse
from ml_function_tpu_torch.parallel.launch import spawn

torch.set_num_threads(1)

PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_ROWS = {"adagrad": jsparse.RowAdagrad, "adam": jsparse.RowAdam}


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _cases():
    crit = dict(n_rows=96, n_dense=2, n_sparse=4, vocab_size=11, embed_dim=4, seed=0)
    base = dict(data="make_criteo_like", opt=("adam", 5e-3), batch=32, steps=3,
                mesh=(2, 2), rows=("adagrad", 0.05))
    cases = {
        "adagrad-a2a": dict(base, model="deepfm", data_kw=crit, hp=dict(hidden=(8,)),
                            grad_exchange="a2a"),
        "adagrad-allgather": dict(base, model="deepfm", data_kw=crit, hp=dict(hidden=(8,)),
                                  grad_exchange="allgather"),
        "adam-a2a": dict(base, model="deepfm", data_kw=crit, hp=dict(hidden=(8,)),
                         grad_exchange="a2a", rows=("adam", 1e-2)),
        # dense SGD: the attention head's bias shifts every score alike, so
        # its gradient is rounding noise, which Adam would blow up to lr
        "din": dict(base, model="din", data="make_behavior_data", steps=2, opt=("sgd", 0.1),
                    data_kw=dict(n_rows=64, n_items=30, n_cates=8, seq_len=8,
                                 vocab_size=13, embed_dim=4, seed=1),
                    hp=dict(hidden=(16, 8)), grad_exchange="a2a"),
    }
    for name in ("ffm", "oenn"):
        cases[name] = dict(base, model=name, steps=2, grad_exchange="a2a",
                           data_kw=dict(crit, n_sparse=3, vocab_size=9, seed=5),
                           hp={} if name == "ffm" else {"hidden": (8,)})
    # a duplicate-heavy stream: 5 ids a field, B 32 on a (1, 4) mesh
    dup = dict(base, model="fm", steps=2, mesh=(1, 4),
               data_kw=dict(crit, n_rows=64, n_dense=1, vocab_size=5, seed=3))
    cases["fm_allgather"] = dict(dup, grad_exchange="allgather")
    cases["fm_a2a"] = dict(dup, grad_exchange="a2a")
    # a slice holds 32 ids of one rank's 8 rows over 4 owners: 4 uniques a
    # bucket at most, so capacity 5 (< S 32) stays lossless; 1 drops
    cases["fm_a2a_capacity5"] = dict(dup, grad_exchange="a2a", grad_capacity=5)
    cases["fm_a2a_capacity1"] = dict(dup, grad_exchange="a2a", grad_capacity=1)
    fm = dict(base, model="fm", steps=1, data_kw=dict(crit, n_rows=64, seed=0))
    cases["fm_exact"] = dict(fm, grad_exchange="a2a")
    cases["fm_bf16"] = dict(fm, grad_exchange="a2a", compress="bf16")
    return cases


def _jax_sparse(case):
    fs, data = getattr(jsyn, case["data"])(**case["data_kw"])
    model = jax_get_model(case["model"], fs, **case.get("hp", {}))
    dense_opt = {"adam": optax.adam, "sgd": optax.sgd}[case["opt"][0]](case["opt"][1])
    name, lr = case["rows"]
    row_opt = JAX_ROWS[name](lr)
    ts = jsparse.create_sparse_train_state(model, jax.random.PRNGKey(0), dense_opt, row_opt)
    params = jax.tree_util.tree_map(np.asarray, ts.params)
    step = jsparse.make_sparse_train_step(model, dense_opt, row_opt, donate=False)
    losses = []
    for b in list(jloop.iter_batches(data, case["batch"]))[:case["steps"]]:
        ts, out = step(ts, b)
        losses.append(float(out["loss"]))
    return params, {"losses": losses,
                    "params": jax.tree_util.tree_map(np.asarray, ts.params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("parallel_sparse"))
    old = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    cases, jax_out, done = _cases(), {}, {}
    try:
        for name, c in cases.items():
            key = repr((c["model"], c["data_kw"], c.get("hp"), c["opt"], c["rows"],
                        c["steps"]))
            if key not in done:      # the exchanges share one JAX run
                done[key] = _jax_sparse(c)
            c["params"], jax_out[name] = done[key]
    finally:
        if old is None:
            os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(cases, f)
    spawn(worker.sparse_cases, 4, (io_dir,), store_dir=io_dir)
    port = {}
    for r in range(4):
        with open(os.path.join(io_dir, f"results_{r}.pkl"), "rb") as f:
            port[r] = pickle.load(f)
    return jax_out, port


def _match(want, got):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    w, g = _flat(want["params"]), _flat(got["params"])
    assert sorted(w) == sorted(g)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **PARAM_TOL)


@pytest.mark.parametrize("name", ["adagrad-a2a", "adagrad-allgather", "adam-a2a"])
def test_sharded_sparse_matches_single_device(runs, name):
    """Three sparse steps on row-sharded tables, both gradient exchanges,
    equal the JAX single-device sparse step: losses and every parameter;
    the row states live beside their blocks."""
    jax_out, port = runs
    _match(jax_out[name], port[0][name])
    rows = port[0][name]["row_shapes"]
    assert rows["table"][next(iter(rows["table"]))][0] == port[0][name]["layout"][
        "embedding.table"][1] // 2


@pytest.mark.parametrize("name", ["ffm", "oenn"])
def test_sharded_sparse_supports_aux_table_models(runs, name):
    """The aux tables (FFM's blocks, OENN's per-order tables) are padded and
    row-sharded like the fused table and ride the same exchanges: two steps
    equal the JAX single-device sparse step."""
    jax_out, port = runs
    got = port[0][name]
    aux = [k for k in got["layout"] if "." not in k]
    assert aux and all(k in got["row_shapes"] for k in aux)
    _match(jax_out[name], got)


def test_sharded_sparse_seq_model(runs):
    """DIN's sequence lookups on the sparse sharded path: two steps equal the
    JAX single-device sparse step."""
    jax_out, port = runs
    _match(jax_out["din"], port[0]["din"])


def test_grad_a2a_equals_allgather_with_capacity_and_dupes(runs):
    """On a duplicate-heavy stream over four owners, the owner-routed
    exchange equals the allgather one, at the lossless default capacity and
    at capacity 5 (below the slice of 32: duplicates share a slot); a
    capacity of 1 drops unique ids and counts them."""
    jax_out, port = runs
    ref = _flat(port[0]["fm_allgather"]["params"])
    for name in ("fm_a2a", "fm_a2a_capacity5"):
        got = _flat(port[0][name]["params"])
        for k in ref:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {k}")
    _match(jax_out["fm_allgather"], port[0]["fm_allgather"])
    assert port[0]["fm_a2a_capacity5"]["overflow"] == [0, 0]
    dropped = port[0]["fm_a2a_capacity1"]["overflow"]
    assert all(d > 0 for d in dropped)
    assert all(port[r]["fm_a2a_capacity1"]["overflow"] == dropped for r in range(4))


def test_sharded_sparse_with_bf16_compress(runs):
    """``compress='bf16'`` reaches the collective gather on the sparse path:
    close to the exact exchange, not equal."""
    _, port = runs
    exact, bf16 = port[0]["fm_exact"]["losses"][0], port[0]["fm_bf16"]["losses"][0]
    np.testing.assert_allclose(bf16, exact, rtol=5e-2)
    assert bf16 != exact
