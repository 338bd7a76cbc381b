"""Checkpoints of the port and BatchNorm state across the bridge, on the CPU.

- A port checkpoint round-trips, bit for bit, the parameters, the BatchNorm
  buffers, the optimizer's state (Adam, Adagrad, FTRL, an injected LR and an
  ``embedding_partitioned`` pair), the step and a generator's state; keep-k
  GC, the probe, and the fallback past a torn newest checkpoint with its
  ``.corrupt`` rename.
- A dense checkpoint that the JAX package wrote after 3 optax Adam steps of
  a small xDeepFM loads through ``load_jax_checkpoint``, and one more step
  on each side agrees: with ``ML_FUNCTION_TPU_F32_MATMUL=1`` the loss within
  1e-6 and every parameter within 1e-5·max|p| (the same f32 formulas,
  summed in another order); on the bf16 path the loss within 1e-4 and the
  parameters within 1e-3·max|p| (``ROADMAP.md`` R3: the two packages may
  round a bf16 input one step apart, which moves a gradient element by up
  to 2^-8 of itself and Adam's update by as much).
- A JAX ``MLP(norm='batch')`` crosses with its running state: the eval
  forward within 1e-6, and a train forward's new statistics within 1e-6.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops.core import MLP as JaxMLP
from ml_function_tpu.serving import export_model as jax_export
from ml_function_tpu.train import checkpoint as jckpt
from ml_function_tpu.train import loop as jloop
from ml_function_tpu.train import optimizers as joptim
from ml_function_tpu_torch.bridge import (params_from_numpy, state_buffers,
                                          state_from_numpy)
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.models.base import embed_inputs, stateless
from ml_function_tpu_torch.ops.base import init_parameters
from ml_function_tpu_torch.ops.core import MLP
from ml_function_tpu_torch.ops.embedding import FusedEmbedding
from ml_function_tpu_torch.train import checkpoint as ckpt
from ml_function_tpu_torch.train import loop as tloop
from ml_function_tpu_torch.train import optimizers as toptim

torch.set_num_threads(1)

DATA_KW = dict(n_rows=256, n_dense=3, n_sparse=4, vocab_size=20, embed_dim=4,
               seed=5)
XDFM_HP = {"cin_hidden": (16,), "hidden": (16, 8)}
B = 64            # below 256: the CIN einsum route, no kernel in either package
JAX_STEPS = 3


def _batches(data, n):
    return list(tloop.iter_batches(data, B))[:n]


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                     for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bn_model(fs, seed=0):
    """Embedding → MLP(norm='batch') → logit: a model with running state
    (no registry model has one)."""
    din = len(fs.sparse) * fs.embed_dim + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(din, (8,), norm="batch", out_dim=1)}

    def fwd(m, batch, train):
        x = embed_inputs(m.embedding, batch, with_linear=False)
        h = torch.cat([x["emb"].flatten(1), x["dense"]], dim=-1)
        return m.mlp(h, train)[:, 0], {"emb_l2": x["l2"]}

    model = stateless("bn_mlp", fs, parts, fwd)
    return init_parameters(model, torch.Generator().manual_seed(seed))


def _snapshot(ts):
    """Everything a checkpoint holds, as numpy, keyed as in the file."""
    return {k: np.array(v, copy=True) for k, v in ckpt.state_arrays(ts).items()}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _train(model, opt, batches, gen=None):
    step = tloop.make_train_step(model, opt)
    for b in batches:
        step(b)
        if gen is not None:
            torch.rand(3, generator=gen)     # a step that draws
    return len(batches)


OPTIMIZERS = {
    "adam": lambda: toptim.make_optimizer("adam", 1e-2),
    "adagrad": lambda: toptim.make_optimizer("adagrad", 5e-2),
    "ftrl": lambda: toptim.make_optimizer("ftrl", 5e-2, lambda1=1e-3),
    "adam_injected": lambda: toptim.make_optimizer("adam", 1e-2, inject_lr=True),
    "partitioned": lambda: toptim.embedding_partitioned(
        toptim.make_optimizer("adam", 1e-2)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_round_trip_is_bit_exact(tmp_path, name):
    fs, data = make_criteo_like(**DATA_KW)
    model = _bn_model(fs)
    opt = OPTIMIZERS[name]().init(model)
    if name == "adam_injected":
        toptim.set_learning_rate(opt, 3e-3)
    gen = torch.Generator().manual_seed(7)
    batches = _batches(data, 4)
    steps = _train(model, opt, batches[:3], gen)
    ts = tloop.TrainState(model, opt, steps, gen)
    want = _snapshot(ts)
    path = ckpt.save_checkpoint(str(tmp_path), ts, extra={"epoch": 1})
    assert os.path.basename(path) == "ckpt_0000000003"
    assert any(k.startswith("model_state/mlp/layer0/") for k in want)

    fresh = _bn_model(fs, seed=1)
    opt2 = OPTIMIZERS[name]().init(fresh)
    gen2 = torch.Generator().manual_seed(99)
    got, extra = ckpt.restore_checkpoint(path, tloop.TrainState(fresh, opt2, 0, gen2))
    assert got.step == 3 and extra == {"epoch": 1}
    _assert_same(_snapshot(got), want)
    # the two runs go on identically: one more step each, the same bits
    _train(model, opt, batches[3:], gen)
    _train(fresh, opt2, batches[3:], gen2)
    _assert_same(_snapshot(tloop.TrainState(fresh, opt2, 4, gen2)),
                 _snapshot(tloop.TrainState(model, opt, 4, gen)))


def test_keep_last_k_and_torn_fallback(tmp_path):
    fs, data = make_criteo_like(**DATA_KW)
    model = get_model("deepfm", fs, device="cpu", hidden=(8,))
    opt = toptim.make_optimizer("adam", 1e-2).init(model)
    step = tloop.make_train_step(model, opt)
    d = str(tmp_path / "ck")
    snaps = {}
    for i, b in enumerate(_batches(data, 4), start=1):
        step(b)
        ts = tloop.TrainState(model, opt, i)
        ckpt.save_checkpoint(d, ts, keep=3)
        snaps[i] = _snapshot(ts)
    names = [os.path.basename(p) for p in ckpt.all_checkpoints(d)]
    assert names == [f"ckpt_{i:010d}" for i in (2, 3, 4)]
    assert ckpt.latest_checkpoint(d).endswith("ckpt_0000000004")
    assert not [n for n in os.listdir(d) if n.startswith(".tmp_")]

    # step 4 truncated (a torn write), step 3's manifest gone
    arrays = os.path.join(d, "ckpt_0000000004", "arrays.npz")
    with open(arrays, "r+b") as f:
        f.truncate(os.path.getsize(arrays) // 2)
    os.remove(os.path.join(d, "ckpt_0000000003", "manifest.json"))
    fresh = get_model("deepfm", fs, device="cpu", hidden=(8,),
                      generator=torch.Generator().manual_seed(3))
    opt2 = toptim.make_optimizer("adam", 1e-2).init(fresh)
    got, _, path = ckpt.restore_latest(d, tloop.TrainState(fresh, opt2, 0))
    assert path.endswith("ckpt_0000000002") and got.step == 2
    _assert_same(_snapshot(got), snaps[2])
    assert sorted(os.listdir(d)) == ["ckpt_0000000002", "ckpt_0000000003.corrupt",
                                     "ckpt_0000000004.corrupt"]
    got2, extra2, path2 = ckpt.restore_latest(str(tmp_path / "none"),
                                              tloop.TrainState(fresh, opt2, 0))
    assert got2 is None and extra2 == {} and path2 == ""


def test_probe_checkpoint(tmp_path):
    fs, _ = make_criteo_like(**DATA_KW)
    model = get_model("fm", fs, device="cpu")
    opt = toptim.make_optimizer("adam", 1e-2).init(model)
    path = ckpt.save_checkpoint(str(tmp_path), tloop.TrainState(model, opt, 0))
    ckpt._probe_checkpoint(path)                  # intact: no raise
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["keys"].append("params/not_there")
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(KeyError):
        ckpt._probe_checkpoint(path)
    with open(os.path.join(path, "arrays.npz"), "wb") as f:
        f.write(b"PK\x03\x04 torn")
    with pytest.raises(ckpt._UNREADABLE):
        ckpt._probe_checkpoint(path)


def test_a_truncated_npz_is_unreadable_to_both_packages(tmp_path):
    """A truncated ``arrays.npz`` raises ``zipfile.BadZipFile``, which the
    port counts as a torn checkpoint; the JAX package's ``restore_latest``
    does not catch it (``ROADMAP.md`` Queue 3, R11) and raises."""
    import zipfile
    fs, _ = jax_make(**DATA_KW)
    jm = jax_get_model("fm", fs)
    opt = joptim.make_optimizer("adam", 1e-2)
    ts = jloop.create_train_state(jm, jax.random.PRNGKey(0), opt)
    path = jckpt.save_checkpoint(str(tmp_path), ts)
    arrays = os.path.join(path, "arrays.npz")
    with open(arrays, "r+b") as f:
        f.truncate(os.path.getsize(arrays) // 2)
    with pytest.raises(zipfile.BadZipFile):
        jckpt.restore_latest(str(tmp_path), ts)
    assert issubclass(zipfile.BadZipFile, ckpt._UNREADABLE)


def test_sharded_format_raises_naming_item_8(tmp_path):
    """Since item 8a the sharded format is written and read (here one rank's
    unsharded state round-trips through it bit for bit); since item 8b the
    sequence-sharded search and pipeline flags are accepted, and at a model
    group of 1 the restored model scores with the unflagged bits under
    them; and a manifest that claims shards its directory lacks reads as
    torn."""
    from ml_function_tpu_torch.parallel.context import sharded_embeddings
    from ml_function_tpu_torch.parallel.mesh import make_mesh
    fs, data = make_criteo_like(**DATA_KW)
    model = get_model("fm", fs, device="cpu")
    ts = tloop.TrainState(model, toptim.make_optimizer("adam").init(model), 0)
    _train(model, ts.optimizer, _batches(data, 1))
    ts.step = 1
    want = _snapshot(ts)
    path = ckpt.save_checkpoint(str(tmp_path / "a"), ts, format="sharded")
    assert sorted(os.listdir(path)) == ["manifest.json", "shards_00000.npz"]
    model2 = get_model("fm", fs, device="cpu", generator=torch.Generator().manual_seed(1))
    ts2, _ = ckpt.restore_checkpoint(
        path, tloop.TrainState(model2, toptim.make_optimizer("adam").init(model2), 0))
    _assert_same(_snapshot(ts2), want)
    batch = _batches(data, 1)[0]
    with torch.no_grad():
        want_logits = model2(batch)[0]
        for flag in ({"seq_shard": True}, {"pp_microbatches": 2}):
            with sharded_embeddings(make_mesh(device="cpu"), **flag):
                assert torch.equal(model2(batch)[0], want_logits)
    path = ckpt.save_checkpoint(str(tmp_path / "b"), ts)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["format"] = "sharded"
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ckpt._UNREADABLE):
        ckpt.restore_checkpoint(path, ts)


# ---------------------------------------------------------------------------
# a JAX checkpoint continued in the port


def _jax_run(f32: bool, ck_dir: str):
    """3 optax Adam steps of the JAX xDeepFM, a dense checkpoint, then the
    4th step: (checkpoint path, 4th loss, parameters after it)."""
    saved = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1" if f32 else "0"
    try:
        fs, data = jax_make(**DATA_KW)
        jm = jax_get_model("xdeepfm", fs, **XDFM_HP)
        opt = joptim.make_optimizer("adam", 1e-2)
        ts = jloop.create_train_state(jm, jax.random.PRNGKey(0), opt)
        step = jloop.make_train_step(jm, opt, donate=False)
        batches = _batches(data, JAX_STEPS + 1)
        for b in batches[:JAX_STEPS]:
            ts, _ = step(ts, b)
        path = jckpt.save_checkpoint(ck_dir, ts, extra={"from": "jax"})
        ts, out = step(ts, batches[JAX_STEPS])
        return path, float(out["loss"]), _flat_jax(ts.params)
    finally:
        if saved is None:
            os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
        else:
            os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = saved


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return {f32: _jax_run(f32, str(tmp_path_factory.mktemp(f"jax{int(f32)}")))
            for f32 in (True, False)}


@pytest.mark.parametrize("f32,loss_bar,param_bar", [(True, 1e-6, 1e-5),
                                                     (False, 1e-4, 1e-3)])
def test_jax_checkpoint_continues_in_the_port(jax_runs, monkeypatch, f32,
                                              loss_bar, param_bar):
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    path, jax_loss, jax_params = jax_runs[f32]
    fs, data = make_criteo_like(**DATA_KW)
    model = get_model("xdeepfm", fs, device="cpu",
                      generator=torch.Generator().manual_seed(9), **XDFM_HP)
    opt = toptim.make_optimizer("adam", 1e-2).init(model)
    ts, extra = ckpt.load_jax_checkpoint(path, model, opt)
    assert ts.step == JAX_STEPS and opt.count == JAX_STEPS
    assert extra == {"from": "jax"}
    mu = opt.state[model.embedding.table]["mu"]
    assert float(mu.abs().max()) > 0          # optax's moments, not zeros
    out = tloop.make_train_step(model, opt)(_batches(data, JAX_STEPS + 1)[JAX_STEPS])
    assert abs(float(out["loss"]) - jax_loss) <= loss_bar * max(1.0, abs(jax_loss))
    got = {n.replace(".", "/"): p.detach().numpy() for n, p in model.named_parameters()}
    assert sorted(got) == sorted(jax_params)
    for k, want in jax_params.items():
        _close(got[k], want, param_bar)


def test_jax_partitioned_and_schedule_optimizer_state(tmp_path):
    """optax's nested chains (an ``embedding_partitioned`` pair, a cosine
    schedule's extra count) map onto the port's rules by name."""
    fs, data = jax_make(**DATA_KW)
    jm = jax_get_model("deepfm", fs, hidden=(8,))
    for spec, tspec in (
            (joptim.embedding_partitioned(joptim.make_optimizer("adam", 1e-2)),
             toptim.embedding_partitioned(toptim.make_optimizer("adam", 1e-2))),
            (joptim.make_optimizer("adagrad", 5e-2, schedule="cosine"),
             toptim.make_optimizer("adagrad", 5e-2, schedule="cosine"))):
        ts = jloop.create_train_state(jm, jax.random.PRNGKey(0), spec)
        step = jloop.make_train_step(jm, spec, donate=False)
        for b in _batches(data, 2):
            ts, _ = step(ts, b)
        path = jckpt.save_checkpoint(str(tmp_path / str(id(spec))), ts)
        jflat = _flat_jax(ts.opt_state)
        model = get_model("deepfm", make_criteo_like(**DATA_KW)[0], device="cpu",
                          hidden=(8,))
        opt = tspec.init(model)
        ckpt.load_jax_checkpoint(path, model, opt)
        mine = {k[len("opt_state/"):]: v
                for k, v in ckpt.state_arrays(tloop.TrainState(model, opt, 2)).items()
                if k.startswith("opt_state/")}
        leaves = [k for k in jflat if not k.endswith("count")]
        assert len(leaves) == len([k for k in mine if not k.endswith("count")])
        for k, v in mine.items():
            if k.endswith("count"):
                assert int(v) == 2
                continue
            label = k.split("/")[0] if k.split("/")[0] in ("dense", "table") else ""
            rest = k[len(label) + 1:] if label else k
            hits = [jk for jk in leaves if jk.endswith("/" + rest)
                    and (not label or jk.startswith(f"inner_states/{label}/"))]
            assert len(hits) == 1, (k, hits)
            np.testing.assert_array_equal(v, jflat[hits[0]], err_msg=k)


# ---------------------------------------------------------------------------
# BatchNorm state across the bridge


@pytest.fixture(scope="module")
def jax_bn():
    x = np.random.default_rng(0).normal(size=(32, 6)).astype(np.float32)
    mlp = JaxMLP(6, (8, 4), norm="batch", out_dim=1)
    params = mlp.init(jax.random.PRNGKey(0))
    _, state = mlp(params, x, state=mlp.init_state(), train=True)   # moved stats
    y_eval, _ = mlp(params, x, state=state, train=False)
    _, state2 = mlp(params, x * 2.0 + 1.0, state=state, train=True)
    return x, params, state, np.asarray(y_eval), state2


def test_batchnorm_state_crosses_the_bridge(jax_bn, tmp_path):
    x, params, state, y_eval, state2 = jax_bn
    port = MLP(6, (8, 4), norm="batch", out_dim=1)
    assert sorted(state_buffers(port)) == sorted(_flat_jax(state))
    # through a JAX export's weights.npz (params/..., state/...), the keys
    # load_scorer reads
    jax_export(str(tmp_path), "mlp", make_criteo_like(**DATA_KW)[0], params,
               model_state=state)
    with np.load(os.path.join(tmp_path, "weights.npz")) as arrays:
        assert any(k.startswith("state/") for k in arrays.files)
        params_from_numpy(port, dict(arrays))
    with torch.no_grad():
        y = port(torch.from_numpy(x), train=False).numpy()
    _close(y, y_eval, 1e-6)
    # a train forward moves the running statistics as the JAX one does
    with torch.no_grad():
        port(torch.from_numpy(x * 2.0 + 1.0), train=True)
    for k, v in _flat_jax(state2).items():
        _close(state_buffers(port)[k].numpy(), v, 1e-6)
    # strict: a state key the model lacks raises
    with pytest.raises(KeyError):
        state_from_numpy(port, {**_flat_jax(state), "layer9/mean": np.zeros(4)})


def test_fit_takes_batchnorm_state(jax_bn):
    """``fit(init_params=(p, s))`` loads s into the buffers: the same run
    as loading both by hand and stepping over fit's batches."""
    _, _, state, _, _ = jax_bn
    fs, data = make_criteo_like(**DATA_KW)
    src = _bn_model(fs, seed=4)
    with torch.no_grad():
        for i, buf in enumerate(state_buffers(src).values()):
            buf.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(i))
    from ml_function_tpu_torch.bridge import params_to_numpy
    p0 = params_to_numpy(src)
    s0 = {k: v.numpy().copy() for k, v in state_buffers(src).items()}
    nested = {}
    for k, v in s0.items():
        node = nested
        *path, leaf = k.split("/")
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = v
    a = _bn_model(fs, seed=1)
    tloop.fit(a, data, epochs=1, batch_size=B, learning_rate=1e-2,
              init_params=(p0, nested), seed=3)
    b = _bn_model(fs, seed=2)
    params_from_numpy(b, p0)
    state_from_numpy(b, nested)
    _train(b, toptim.make_optimizer("adam", 1e-2).init(b),
           list(tloop.iter_batches(data, B, shuffle=True, seed=3)))
    for (n, pa), (_, pb) in zip(list(a.state_dict().items()), list(b.state_dict().items())):
        np.testing.assert_array_equal(pa.numpy(), pb.numpy(), err_msg=n)
    assert not np.array_equal(state_buffers(a)["mlp/layer0/mean"].numpy(),
                              s0["mlp/layer0/mean"])   # it trained from s0


# ---------------------------------------------------------------------------
# the sharded format (one spawn of 4 gloo ranks for the file,
# ``torch_parallel_worker.checkpoint_cases``)

SHARD_CASE = dict(model="deepfm", data="make_criteo_like",
                  data_kw=dict(n_rows=96, n_dense=2, n_sparse=4, vocab_size=9,
                               embed_dim=4, seed=3),
                  hp=dict(hidden=(8,)), opt=("adam", 1e-2), batch=32)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The ranks' results, the directory they wrote, and the JAX initial
    parameters they started from."""
    import pickle

    import torch_parallel_worker as worker
    from ml_function_tpu_torch.parallel.launch import spawn
    io_dir = str(tmp_path_factory.mktemp("sharded_ckpt"))
    fs, _ = jax_make(**SHARD_CASE["data_kw"])
    params, _ = jax_get_model("deepfm", fs, **SHARD_CASE["hp"]).init(jax.random.PRNGKey(0))
    case = dict(SHARD_CASE, params=jax.tree_util.tree_map(np.asarray, params))
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump({"dense": case}, f)
    spawn(worker.checkpoint_cases, 4, (io_dir,), store_dir=io_dir)
    out = {}
    for r in range(4):
        with open(os.path.join(io_dir, f"results_{r}.pkl"), "rb") as f:
            out[r] = pickle.load(f)
    return out, io_dir


def test_sharded_checkpoint_same_grid(sharded_runs):
    """On the (2, 2) grid that wrote it, every rank reads back its own
    blocks bit for bit (parameters, Adam's moments beside the table rows,
    count, step, generator), and the next step's loss is the same bits; the
    ranks at data coordinate 0 wrote the blocks, rank 0 the manifest and the
    replicated arrays; a sparse-row state's row blocks round-trip too."""
    out, _ = sharded_runs
    for r, res in out.items():
        assert res["step"] == 2 and res["path"].endswith("ckpt_0000000002")
        _assert_same(res["restored"], res["saved"])
        assert res["next_losses"][0] == res["next_losses"][1]
        _assert_same(res["sp_restored"], res["sp_saved"])
        assert res["sp_step"] == 5
    assert out[0]["files"] == ["manifest.json", "shards_00000.npz", "shards_00001.npz"]
    # blocks differ by model coordinate, and agree along the data axis
    t = "params/embedding/table"
    assert not np.array_equal(out[0]["saved"][t], out[1]["saved"][t])
    np.testing.assert_array_equal(out[0]["saved"][t], out[2]["saved"][t])


def test_sharded_checkpoint_torn_shard_falls_back(sharded_runs):
    """A truncated shard file in the newest checkpoint: every rank falls back
    to the step-2 one (rank 0 probes and quarantines, all restore the step
    it broadcast)."""
    out, io_dir = sharded_runs
    for res in out.values():
        name, step, state = res["fallback"]
        assert (name, step) == ("ckpt_0000000002", 2)
        _assert_same(state, res["saved"])
    assert "ckpt_0000000003.corrupt" in os.listdir(os.path.join(io_dir, "ck22"))


def test_sharded_checkpoint_missing_shard_file_falls_back(sharded_runs, tmp_path):
    """A newest checkpoint without ``shards_00001.npz`` (the model-index-1
    blocks) still lists every key in ``shards_00000.npz``, but its blocks
    cover half of each table: the probe counts it torn and the restore
    falls back to the older one; restoring it by name raises rather than
    fill the missing rows with zeros."""
    import shutil
    out, io_dir = sharded_runs
    good = os.path.join(io_dir, "ck22", "ckpt_0000000002")
    shutil.copytree(good, tmp_path / "ckpt_0000000002")
    shutil.copytree(good, tmp_path / "ckpt_0000000003")
    os.remove(tmp_path / "ckpt_0000000003" / "shards_00001.npz")
    fs, _ = make_criteo_like(**SHARD_CASE["data_kw"])

    def template():
        model = get_model("deepfm", fs, device="cpu", **SHARD_CASE["hp"])
        return tloop.TrainState(model, toptim.make_optimizer("adam", 1e-2).init(model), 0)

    with pytest.raises(KeyError, match="cover"):
        ckpt.restore_checkpoint(str(tmp_path / "ckpt_0000000003"), template())
    ts, _, path = ckpt.restore_latest(str(tmp_path), template())
    assert os.path.basename(path) == "ckpt_0000000002" and ts.step == 2
    assert "ckpt_0000000003.corrupt" in os.listdir(tmp_path)
    v = fs.total_vocab
    blocks = [out[r]["saved"]["params/embedding/table"] for r in (0, 1)]
    np.testing.assert_array_equal(_snapshot(ts)["params/embedding/table"],
                                  np.concatenate(blocks)[:v])


@pytest.mark.parametrize("template", ["unsharded", "sharded_1x1"])
def test_sharded_checkpoint_another_grid(sharded_runs, template):
    """The (2, 2) checkpoint restored on one rank: every table stitched from
    its blocks and its padding dropped, into an unsharded state or a (1, 1)
    sharded one; the parameters are the ranks' gathered ones bit for bit,
    and Adam's moments the stitched blocks'."""
    from ml_function_tpu_torch.parallel.mesh import make_mesh
    from ml_function_tpu_torch.parallel.train import create_sharded_state
    out, io_dir = sharded_runs
    fs, _ = make_criteo_like(**SHARD_CASE["data_kw"])
    model = get_model("deepfm", fs, device="cpu", generator=torch.Generator().manual_seed(4),
                      **SHARD_CASE["hp"])
    spec = toptim.make_optimizer("adam", 1e-2)
    ts = (tloop.TrainState(model, spec.init(model), 0) if template == "unsharded"
          else create_sharded_state(model, spec, make_mesh(device="cpu")))
    ts, _ = ckpt.restore_checkpoint(os.path.join(io_dir, "ck22", "ckpt_0000000002"), ts)
    assert ts.step == 2
    got = _snapshot(ts)
    full = out[0]["full"]
    for name, p in ts.model.named_parameters():
        *path, leaf = name.split(".")
        node = full
        for k in path:
            node = node[int(k)] if isinstance(node, list) else node[k]
        np.testing.assert_array_equal(p.detach().numpy(), node[leaf], err_msg=name)
    v = fs.total_vocab
    for key in ("opt_state/mu/embedding/table", "opt_state/nu/embedding/linear"):
        blocks = [out[r]["saved"][key] for r in (0, 1)]
        np.testing.assert_array_equal(got[key], np.concatenate(blocks)[:v], err_msg=key)
    assert got["opt_state/count"] == 2


def test_jax_sharded_checkpoint_imported(tmp_path):
    """A sharded checkpoint that the JAX package wrote from a (2, 2) mesh
    (padded tables, blocks in shard files) loads through
    ``load_jax_checkpoint``: stitched, unpadded, the parameters and Adam's
    state equal to the JAX state's."""
    import optax

    from ml_function_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ml_function_tpu.parallel.train import (create_sharded_state,
                                                make_sharded_train_step, shard_batch)
    jfs, data = jax_make(**SHARD_CASE["data_kw"])
    jm = jax_get_model("deepfm", jfs, **SHARD_CASE["hp"])
    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    opt = optax.adam(1e-2)
    sts = create_sharded_state(jm, jax.random.PRNGKey(0), opt, mesh)
    sts, _ = make_sharded_train_step(jm, opt, mesh, donate=False)(
        sts, shard_batch(next(jloop.iter_batches(data, 32)), mesh))
    path = jckpt.save_checkpoint(str(tmp_path), sts, format="sharded")
    fs, _ = make_criteo_like(**SHARD_CASE["data_kw"])
    model = get_model("deepfm", fs, device="cpu", **SHARD_CASE["hp"])
    popt = toptim.make_optimizer("adam", 1e-2).init(model)
    ts, _ = ckpt.load_jax_checkpoint(path, model, popt)
    assert ts.step == 1 and popt.count == 1
    v = fs.total_vocab
    want = _flat_jax(sts.params)
    for name, p in model.named_parameters():
        key = name.replace(".", "/")
        w = want[key][:p.shape[0]] if p.dim() else want[key]
        np.testing.assert_array_equal(p.detach().numpy(), w, err_msg=name)
    mu = _flat_jax(sts.opt_state[0].mu)
    np.testing.assert_array_equal(popt.state[model.embedding.table]["mu"].numpy(),
                                  mu["embedding/table"][:v])
