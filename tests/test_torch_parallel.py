"""Row-sharded tables and the sharded step of the port (``parallel/``) on
gloo ranks, against the JAX package on a mesh of the same shape.

The cases of ``tests/test_parallel.py`` and ``test_serving.py``'s
``ShardedScorer``: the port runs in 4 spawned processes (one spawn for the
file, ``torch_parallel_worker.parallel_cases``) on (2, 2) and (1, 4) meshes;
the JAX side runs here on 4 of the 8 virtual CPU devices. Both sides start
from the same parameters (the JAX ones, bridged) and the same seeded
batches, with ``ML_FUNCTION_TPU_F32_MATMUL=1`` on both.

Bars, each beside its reason:
- lookup rows within 1e-6 (f32 rows moved, not summed: a psum adds exact
  zeros), their table gradients within 1e-5 (duplicate ids' cotangents
  summed in another order); under ``compress='bf16'`` the rows and
  gradients within the same bars of the JAX package's own bf16 exchange;
- a sharded step's loss within rtol 1e-5 of the single-process step's (the
  global BCE is a sum of per-rank sums), the parameters after it within
  rtol 1e-4, atol 1e-5 (the JAX test's bars: gradients summed over ranks);
- 30 sharded steps: held-out AUC and logloss within 2e-3 of the JAX
  sharded run (the JAX test's bar for sharded against single-device);
- ``ShardedScorer``: probabilities within 1e-6 of the JAX package's.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from ml_function_tpu.features import synthetic as jsyn
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops.embedding import FusedEmbedding as JaxFusedEmbedding
from ml_function_tpu.parallel.embedding import ShardedLookup as JaxShardedLookup
from ml_function_tpu.parallel.embedding import pad_table_for_shards as jax_pad
from ml_function_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ml_function_tpu.parallel.train import create_sharded_state as jax_sharded_state
from ml_function_tpu.parallel.train import make_sharded_eval_step as jax_eval_step
from ml_function_tpu.parallel.train import make_sharded_train_step as jax_sharded_step
from ml_function_tpu.parallel.train import shard_batch as jax_shard_batch
from ml_function_tpu.serving import ShardedScorer as JaxShardedScorer
from ml_function_tpu.train import loop as jloop
from ml_function_tpu.train.metrics import init_metrics as jax_init_metrics
from ml_function_tpu.train.metrics import metrics_summary as jax_summary
from ml_function_tpu_torch.bridge import params_to_numpy
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.parallel.launch import spawn
from ml_function_tpu_torch.parallel.mesh import Mesh, make_mesh
from ml_function_tpu_torch.parallel.train import param_spec_tree
from ml_function_tpu_torch.serving import ShardedScorer
from ml_function_tpu_torch.train.loop import iter_batches, make_train_step
from ml_function_tpu_torch.train.optimizers import make_optimizer

torch.set_num_threads(1)

LOOKUP_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
JAX_OPTS = {"sgd": optax.sgd, "adam": optax.adam}


@pytest.fixture(scope="module", autouse=True)
def _f32():
    old = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    yield
    if old is None:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    else:
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = old


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


# ---------------------------------------------------------------------------
# the cases


def _lookup_cases():
    fs, data = jsyn.make_criteo_like(n_rows=64, n_dense=2, n_sparse=5, vocab_size=13,
                                     embed_dim=4)
    table = np.asarray(JaxFusedEmbedding(fs).init(jax.random.PRNGKey(0))["table"])
    gids = data["sparse"][:16] + np.asarray(fs.sparse_offsets())[None, :]
    base = {"fs": fs, "table": table, "gids": gids, "capacity": None, "compress": None,
            "mesh": (2, 2)}
    cases = {"psum": dict(base, mode="psum"), "a2a": dict(base, mode="a2a"),
             "psum_bf16": dict(base, mode="psum", compress="bf16"),
             "a2a_bf16": dict(base, mode="a2a", compress="bf16")}
    fs4, data4 = jsyn.make_criteo_like(n_rows=24, n_dense=0, n_sparse=3, vocab_size=10,
                                       embed_dim=4)
    t4 = np.asarray(JaxFusedEmbedding(fs4, with_linear=False).init(
        jax.random.PRNGKey(2))["table"])
    cases["a2a_model4"] = dict(base, fs=fs4, table=t4, mode="a2a", mesh=(1, 4),
                               gids=data4["sparse"][:24] + np.asarray(fs4.sparse_offsets()))
    fsd, _ = jsyn.make_criteo_like(n_rows=8, n_dense=0, n_sparse=4, vocab_size=13,
                                   embed_dim=4)
    td = np.asarray(JaxFusedEmbedding(fsd, with_linear=False).init(
        jax.random.PRNGKey(0))["table"])
    offs = np.asarray(fsd.sparse_offsets())[None, :]
    dup = np.random.default_rng(3).choice([1, 5, 9], size=(16, 4)) + offs
    cases["a2a_dedup_capacity4"] = dict(base, fs=fsd, table=td, gids=dup, mode="a2a",
                                        capacity=4)
    cases["a2a_overflow_capacity1"] = dict(base, fs=fsd, table=td, mode="a2a", capacity=1,
                                           gids=np.ones((16, 4), np.int64) + offs)
    return cases


def _step_cases():
    crit = dict(n_rows=48, n_dense=2, n_sparse=4, vocab_size=9, embed_dim=4, seed=7)
    cases = {
        # the batch: a ragged tail (16 rows and 16 padded with weight 0)
        "fm": dict(model="fm", data="make_criteo_like", data_kw=crit, opt=("sgd", 0.1)),
        "lr_odd_vocab": dict(model="lr", data="make_criteo_like",
                             data_kw=dict(crit, n_sparse=3, vocab_size=11, seed=9),
                             opt=("sgd", 0.1)),
        "mmoe_experts": dict(model="mmoe", data="make_cvr_data",
                             data_kw=dict(crit, seed=13), opt=("sgd", 0.1),
                             hp=dict(n_experts=4, expert_hidden=(8,), tower_hidden=(8,))),
        "din": dict(model="din", data="make_behavior_data",
                    data_kw=dict(n_rows=48, n_items=30, n_cates=8, seq_len=8,
                                 vocab_size=13, embed_dim=4, seed=11),
                    opt=("sgd", 0.1), hp=dict(hidden=(16, 8))),
    }
    for mode in ("psum", "a2a"):
        for compress in (None, "bf16"):
            cases[f"deepfm_{mode}_{compress}"] = dict(
                model="deepfm", data="make_criteo_like", data_kw=crit, opt=("adam", 1e-3),
                hp=dict(hidden=(8,)), exchange=mode, compress=compress)
    cases["deepfm_a2a_capacity2"] = dict(cases["deepfm_a2a_None"], capacity=2)
    for c in cases.values():
        c.update(mesh=(2, 2), batch=32, which=[1])
    cases["fm_model4"] = dict(cases["fm"], mesh=(1, 4))
    # SGD: the bias before a BatchNorm has a gradient of rounding noise only,
    # which Adam would blow up to steps of lr
    cases["bn_mlp"] = dict(model="bn_mlp", data="make_criteo_like", data_kw=crit,
                           opt=("sgd", 0.1), mesh=(2, 2), batch=32, which=[0, 1])
    return cases


def _jax_step(case):
    """The JAX package's single-device steps of a step case, and its initial
    parameters (handed to the ranks)."""
    fs, data = getattr(jsyn, case["data"])(**case["data_kw"])
    model = jax_get_model(case["model"], fs, **case.get("hp", {}))
    name, lr = case["opt"]
    opt = JAX_OPTS[name](lr)
    ts = jloop.create_train_state(model, jax.random.PRNGKey(3), opt)
    params = _np(ts.params)
    step = jloop.make_train_step(model, opt, donate=False)
    batches = list(jloop.iter_batches(data, case["batch"]))
    losses = []
    for i in case["which"]:
        ts, out = step(ts, batches[i])
        losses.append(float(out["loss"]))
    return params, {"losses": losses, "params": _np(ts.params)}


RUN = dict(model="xdeepfm", data="make_criteo_like",
           data_kw=dict(n_rows=2048, n_dense=3, n_sparse=5, vocab_size=17, embed_dim=4,
                        seed=11),
           hp=dict(hidden=(16, 8), cin_hidden=(8,)), opt=("adam", 3e-3), batch=128,
           epochs=2, steps=30, mesh=(2, 2))


def _jax_run(mesh):
    fs, data = jsyn.make_criteo_like(**RUN["data_kw"])
    model = jax_get_model("xdeepfm", fs, **RUN["hp"])
    opt = optax.adam(3e-3)
    sts = jax_sharded_state(model, jax.random.PRNGKey(4), opt, mesh)
    params = _np(sts.params)            # padded for the model axis
    step = jax_sharded_step(model, opt, mesh, donate=False)
    n = 0
    for epoch in range(RUN["epochs"]):
        for b in jloop.iter_batches(data, RUN["batch"], shuffle=True, seed=epoch):
            if n == RUN["steps"]:
                break
            sts, _ = step(sts, jax_shard_batch(b, mesh))
            n += 1
    ev = jax_eval_step(model, mesh)
    em = jax_init_metrics()
    for b in jloop.iter_batches(data, RUN["batch"]):
        em = ev(sts.params, sts.model_state, em, jax_shard_batch(b, mesh))
    return params, jax_summary(em)


SCORE = dict(model="deepfm", data="make_criteo_like",
             data_kw=dict(n_rows=100, n_dense=2, n_sparse=4, vocab_size=9, embed_dim=4,
                          seed=2),
             hp=dict(hidden=(8,)), batch=32, n_rows=90, mesh=(2, 2))


def _jax_scores(mesh):
    fs, data = jsyn.make_criteo_like(**SCORE["data_kw"])
    model = jax_get_model("deepfm", fs, **SCORE["hp"])
    params, _ = model.init(jax.random.PRNGKey(5))
    rows = {k: v[:SCORE["n_rows"]] for k, v in data.items() if k != "label"}
    probs = JaxShardedScorer(model, params, mesh, batch_size=SCORE["batch"]).predict_proba(rows)
    return _np(params), probs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on both sides: ``(jax, port)``, the port's results by
    rank."""
    io_dir = str(tmp_path_factory.mktemp("parallel"))
    mesh22 = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    mesh14 = jax_make_mesh(data=1, model=4, devices=jax.devices()[:4])
    jmesh = {(2, 2): mesh22, (1, 4): mesh14}
    jax_out = {"lookups": {}, "steps": {}}
    lookups = _lookup_cases()
    for name, c in lookups.items():
        sl = JaxShardedLookup(jmesh[c["mesh"]], c["fs"], mode=c["mode"],
                              capacity=c["capacity"], compress=c["compress"])
        m = c["mesh"][1]
        tp = jax_pad(jnp.asarray(c["table"]), m)
        gids = jnp.asarray(c["gids"], jnp.int32)
        # jitted: an eager shard_map with a sort dispatches op by op (~20 s)
        rows = jax.jit(sl.lookup)(tp, gids)
        grad = jax.jit(jax.grad(lambda t, g: jnp.sum(jnp.sin(sl.lookup(t, g)))))(tp, gids)
        jax_out["lookups"][name] = {"rows": np.asarray(rows), "grad": np.asarray(grad),
                                    "overflow": int(jax.jit(sl.overflow_count)(gids))}
    steps = _step_cases()
    done = {}
    for name, c in steps.items():
        if c["model"] == "bn_mlp":
            continue
        key = repr((c["model"], c["data_kw"], c.get("hp"), c["opt"]))
        if key not in done:     # one JAX run serves the exchanges and meshes
            done[key] = _jax_step(c)
        c["params"], jax_out["steps"][name] = done[key]
    run = dict(RUN)
    run["params"], jax_out["run"] = _jax_run(mesh22)
    score = dict(SCORE)
    score["params"], jax_out["scores"] = _jax_scores(mesh22)
    inputs = {"lookups": {k: {kk: vv for kk, vv in v.items() if kk != "fs"}
                          for k, v in lookups.items()},
              "steps": steps, "runs": {"xdeepfm": run}, "scorers": {"deepfm": score}}
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    spawn(worker.parallel_cases, 4, (io_dir,), store_dir=io_dir)
    port = {}
    for r in range(4):
        with open(os.path.join(io_dir, f"results_{r}.pkl"), "rb") as f:
            port[r] = pickle.load(f)
    return jax_out, port


# ---------------------------------------------------------------------------
# the collective lookups


@pytest.mark.parametrize("name", ["psum", "a2a", "a2a_model4", "a2a_dedup_capacity4"])
def test_lookup_matches_jax(runs, name):
    """mask+psum and the deduped id all-to-all give the JAX package's rows,
    and their backward its table gradient (the dedup case: 64 ids of three
    values through a capacity-4 exchange, lossless)."""
    jax_out, port = runs
    want, got = jax_out["lookups"][name], port[0]["lookups"][name]
    np.testing.assert_allclose(got["rows"], want["rows"], **LOOKUP_TOL)
    np.testing.assert_allclose(got["grad"], want["grad"], **GRAD_TOL)
    # every rank holds the same table gradient (summed over the data group)
    for r in range(1, 4):
        np.testing.assert_array_equal(port[r]["lookups"][name]["grad"], got["grad"])


@pytest.mark.parametrize("name", ["psum_bf16", "a2a_bf16"])
def test_bf16_compressed_lookup_matches_jax(runs, name):
    """``compress='bf16'`` rounds the rows once, as the JAX exchange does
    (psum: exactly the bf16 cast of each row), and the cotangents where the
    JAX exchange rounds them: the gradients within the f32 bar of the JAX
    package's."""
    jax_out, port = runs
    want, got = jax_out["lookups"][name], port[0]["lookups"][name]
    np.testing.assert_allclose(got["rows"], want["rows"], **LOOKUP_TOL)
    np.testing.assert_allclose(got["grad"], want["grad"], **GRAD_TOL)
    assert np.abs(got["grad"]).sum() > 0
    if name == "psum_bf16":
        exact = port[0]["lookups"]["psum"]["rows"]
        cast = torch.tensor(exact).bfloat16().float().numpy()
        np.testing.assert_array_equal(got["rows"], cast)


def test_a2a_overflow_drops_to_zero_and_counts_like_jax(runs):
    """Capacity 1 and one id everywhere: each slice keeps its first id a
    bucket, the dropped ones read as exact zeros, and the count of dropped
    unique ids is the JAX package's."""
    jax_out, port = runs
    want = jax_out["lookups"]["a2a_overflow_capacity1"]
    got = port[0]["lookups"]["a2a_overflow_capacity1"]
    np.testing.assert_array_equal(got["rows"], want["rows"])
    zero = (got["rows"] == 0).all(axis=-1)
    assert zero.any() and not zero.all()
    assert got["overflow"] == want["overflow"] > 0
    assert port[0]["lookups"]["a2a"]["overflow"] == 0      # no capacity, no drops


# ---------------------------------------------------------------------------
# the sharded step


@pytest.mark.parametrize("name", ["fm", "fm_model4", "lr_odd_vocab", "din", "mmoe_experts",
                                  "deepfm_psum_None", "deepfm_a2a_None"])
def test_sharded_step_matches_single_process(runs, name):
    """One sharded step on a ragged tail batch equals the JAX package's
    single-device step: the loss, and every parameter after it (LR's odd
    vocab padded; MMoE's experts sharded over the model axis; DIN's
    sequence lookups on the collective route)."""
    jax_out, port = runs
    want, got = jax_out["steps"][name], port[0]["steps"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    w, g = _flat(want["params"]), _flat(got["params"])
    assert sorted(w) == sorted(g)
    for k in w:
        np.testing.assert_allclose(g[k], w[k], err_msg=k, **PARAM_TOL)


def test_sharded_layout(runs):
    """The blocks each rank holds: tables padded and row-sharded, MMoE's
    expert stacks split on the expert axis, everything else whole."""
    _, port = runs
    lr = port[0]["steps"]["lr_odd_vocab"]
    assert lr["layout"]["embedding.linear"] == (33, 34)
    assert lr["block_shapes"]["embedding.linear"] == (17, 1)
    mmoe = port[0]["steps"]["mmoe_experts"]
    assert mmoe["block_shapes"]["experts.w.0"][0] == 2
    assert "gates.w" not in mmoe["layout"]
    assert port[0]["coords"] == (0, 0) and port[3]["coords"] == (1, 1)


def test_exchanges_and_compression_agree(runs):
    """Both exchanges give one loss (rtol 1e-5, the JAX test's bar); the
    bf16-compressed steps stay within 5e-3 of the exact one (the JAX
    test's bar)."""
    _, port = runs
    s = port[0]["steps"]
    exact = s["deepfm_psum_None"]["losses"][0]
    assert np.isclose(s["deepfm_a2a_None"]["losses"][0], exact, rtol=1e-5)
    for name in ("deepfm_psum_bf16", "deepfm_a2a_bf16"):
        assert np.isclose(s[name]["losses"][0], exact, atol=5e-3), name


def test_step_reports_a2a_overflow(runs):
    """A finite capacity puts ``a2a_overflow`` in the step's output: the
    global count of dropped unique ids, positive at capacity 2."""
    _, port = runs
    got = port[0]["steps"]["deepfm_a2a_capacity2"]["overflow"][0]
    assert got > 0
    assert all(port[r]["steps"]["deepfm_a2a_capacity2"]["overflow"][0] == got
               for r in range(4))
    assert port[0]["steps"]["deepfm_a2a_None"]["overflow"][0] is None


def test_batchnorm_takes_the_global_batch(runs):
    """BatchNorm under data 2 takes the global batch's moments: two sharded
    SGD steps equal the port's single-process steps (loss rtol 1e-5,
    parameters 1e-4/1e-5, running buffers 1e-5), and every rank holds the
    same buffers."""
    _, port = runs
    case = _step_cases()["bn_mlp"]
    fs, data, model = worker.build(case)
    opt = make_optimizer("sgd", 0.1).init(model)
    step = make_train_step(model, opt)
    batches = list(iter_batches(data, 32))
    losses = [float(step(b)["loss"]) for b in batches]
    got = port[0]["steps"]["bn_mlp"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    want = _flat(params_to_numpy(model))
    for k, v in _flat(got["params"]).items():
        np.testing.assert_allclose(v, want[k], err_msg=k, **PARAM_TOL)
    for k, v in worker.full_state(model).items():
        np.testing.assert_allclose(got["state"][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
        for r in range(1, 4):
            np.testing.assert_array_equal(port[r]["steps"]["bn_mlp"]["state"][k],
                                          got["state"][k])


def test_thirty_sharded_steps_match_the_jax_sharded_run(runs):
    """xDeepFM from the JAX sharded state's (padded) parameters: 30 steps on
    a (2, 2) mesh, then the streaming eval; AUC and logloss within 2e-3 of
    the JAX run on its (2, 2) mesh."""
    jax_out, port = runs
    want, got = jax_out["run"], port[0]["runs"]["xdeepfm"]
    assert got["steps"] == 30
    assert want["auc"] > 0.55
    np.testing.assert_allclose(got["eval"]["auc"], want["auc"], atol=2e-3)
    np.testing.assert_allclose(got["eval"]["logloss"], want["logloss"], atol=2e-3)
    assert got["eval"]["count"] == want["count"]


# ---------------------------------------------------------------------------
# ShardedScorer and the refusals


def test_sharded_scorer_matches_jax(runs):
    """Every rank returns the full probabilities of 90 rows (a padded tail
    batch) from blocks of the table, those of the JAX ShardedScorer."""
    jax_out, port = runs
    for r in range(4):
        got = port[r]["scorers"]["deepfm"]
        np.testing.assert_allclose(got["probs"], jax_out["scores"], rtol=1e-6, atol=1e-6)
    assert port[0]["scorers"]["deepfm"]["block_rows"] == 18      # 36 rows over 2


def test_sharded_scorer_and_mesh_refusals():
    fs, _ = make_criteo_like(n_rows=8, n_sparse=3, vocab_size=7, embed_dim=4)
    model = get_model("deepfm", fs, device="cpu", hidden=(8,))
    mesh = Mesh(2, 1, (0, 0), (0, 1), None, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        ShardedScorer(model, mesh, batch_size=33)
    with pytest.raises(ValueError, match="mesh 2x1 != 1"):
        make_mesh(2, 1, device="cpu")
    # the sequence-sharded search and pipeline flags are accepted, and at a
    # model group of 1 the sharded step gives the unflagged step's bits
    from ml_function_tpu_torch.parallel.train import create_sharded_state, make_sharded_train_step
    _, data = make_criteo_like(n_rows=32, n_sparse=3, vocab_size=7, embed_dim=4)
    one = make_mesh(device="cpu")
    got = []
    for flag in ({}, {"seq_shard": True}, {"pp_microbatches": 2}):
        m = get_model("autoint", fs, device="cpu", generator=torch.Generator().manual_seed(0))
        ts = create_sharded_state(m, make_optimizer("adam", 1e-2), one)
        out = make_sharded_train_step(ts.model, ts.optimizer, one, **flag)(data)
        got.append((out["loss"], [p.detach().clone() for p in ts.model.parameters()]))
    for loss, params in got[1:]:
        assert torch.equal(loss, got[0][0])
        assert all(torch.equal(a, b) for a, b in zip(params, got[0][1]))


def test_param_spec_tree_marks_tables():
    fs, _ = make_criteo_like(n_rows=8, n_sparse=3, vocab_size=7, embed_dim=4)
    specs = param_spec_tree(get_model("deepfm", fs, device="cpu", hidden=(8,)))
    assert specs["embedding.table"] == ("model", None)
    assert specs["embedding.linear"] == ("model", None)
    assert specs["mlp.layer0.dense.w"] == ()
