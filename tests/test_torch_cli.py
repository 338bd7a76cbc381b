"""The port's CLI (``train/cli.py``) against the JAX package's, the cases of
``tests/test_cli.py``: one process here, and four gloo ranks on a (2, 2)
mesh (one spawn for the file, ``torch_parallel_worker.cli_cases``) for the
sharded runs, so that their batches, losses and eval merge cross the data
group as their tables cross the model group.

Each run starts from the JAX CLI's initial parameters, bridged (the test
wraps both packages' ``create_sharded_state`` and
``create_sparse_sharded_state``), on the same data (``build_data`` bit for
bit), and is held to the JAX CLI's run on the same arguments (each test's
JAX runs in a child process of its own, ``jax_runs``): the same
number of steps and of eval rows, and the eval AUC and logloss within 2e-3
(the JAX package's bar for a sharded run against a single-device one: the
two meshes sum the global batch's gradients in another order, and here the
JAX CLI's mesh spans the 8 virtual devices, the port's the ranks it has).
A resumed run is held to the uninterrupted one: the same eval AUC and
logloss within 1e-6 (one rank's sums against another's order), since every
step after the checkpoint repeats the uninterrupted run's; a run with the
sequence-sharded search or the pipeline flag, to the same run without it.
"""

import json
import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from ml_function_tpu.train import cli as jcli
from ml_function_tpu.train.config import Config as JConfig
from ml_function_tpu.train.config import apply_overrides as japply
from ml_function_tpu_torch.features.schema import FeatureSet, SparseSpec
from ml_function_tpu_torch.parallel.launch import spawn
from ml_function_tpu_torch.train import cli

torch.set_num_threads(1)

METRIC_TOL = dict(rtol=0, atol=2e-3)
RANKS = 4                     # a (2, 2) mesh under --config.mesh.model=2

SYNTH = ["--config.model.name=deepfm", "--config.model.hidden=(16,8)",
         "--config.data.n_rows=4096", "--config.data.vocab_size=50",
         "--config.train.batch_size=256", "--config.train.learning_rate=0.01",
         "--config.train.log_every=0"]
SPARSE_ROW = SYNTH + ["--config.train.row_optimizer=adagrad",
                      "--config.train.row_learning_rate=0.05",
                      "--config.mesh.model=2", "--config.train.epochs=2"]
FM = ["--config.model.name=fm", "--config.data.n_rows=4096",
      "--config.data.vocab_size=50", "--config.train.batch_size=256",
      "--config.train.learning_rate=0.01", "--config.train.log_every=0",
      "--config.mesh.model=2"]
AUTO_CAPACITY = FM + ["--config.mesh.exchange=a2a", "--config.mesh.capacity=auto"]
FM_TWO_EPOCHS = FM + ["--config.train.epochs=2"]
SMALL = ["--config.data.n_rows=1024", "--config.train.batch_size=256",
         "--config.train.learning_rate=0.01", "--config.train.log_every=0",
         "--config.mesh.model=2"]
# the reference's sequence-sharded search (SIM over the behavior data, its
# 8-long streams split over the model axis) and pipeline (AutoInt's 2 blocks
# as 2 stages)
FLAG_RUNS = {"--config.mesh.seq_shard=true": ["--config.model.name=sim",
                                              "--config.data.seq_len=8"] + SMALL,
             "--config.mesh.pp_microbatches=2": ["--config.model.name=autoint",
                                                 "--config.data.vocab_size=50"] + SMALL}


@pytest.fixture(scope="module", autouse=True)
def _f32():
    """f32 matmuls in both packages (the spawned ranks inherit it)."""
    old = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    yield
    if old is None:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    else:
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = old


CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_cli_child.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_runs(argvs, io_dir):
    """The JAX CLI's runs on each of ``argvs`` (its result and its initial
    ``(params, model_state)`` as numpy), all in one child process
    (``jax_cli_child.py``, under ``python -X faulthandler``), set up as
    ``tests/conftest.py`` sets this one up. XLA's CPU runtime can abort a
    process in the jitted step (``ROADMAP.md`` D6); in a child that takes
    down the child alone, and the failure carries its exit signal and its
    stderr. No retry."""
    src, dst = os.path.join(io_dir, "jax_in.pkl"), os.path.join(io_dir, "jax_out.pkl")
    with open(src, "wb") as f:
        pickle.dump(list(argvs), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    # XLA's CPU collectives end the process when a device's thread waits 40 s
    # in a rendezvous ("Termination timeout for `all reduce ...` of 40 seconds
    # exceeded"), which a child starved by the other test workers met; the
    # guard against a hang stays, at 180 s
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_collective_call_terminate_timeout_seconds=180").strip()
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [q for q in env.get("PYTHONPATH", "").split(os.pathsep) if q])
    out = subprocess.run([sys.executable, "-X", "faulthandler", CHILD, src, dst], env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        how = (f"signal {signal.Signals(-out.returncode).name}" if out.returncode < 0
               else f"exit code {out.returncode}")
        pytest.fail(f"the JAX CLI's child process ended with {how}; its stderr:\n"
                    f"{out.stderr[-20000:]}", pytrace=False)
    with open(dst, "rb") as f:
        return pickle.load(f)


def jax_run(argv, io_dir):
    """The JAX CLI's run on ``argv`` alone (``jax_runs``)."""
    return jax_runs([argv], io_dir)[0]


def port_run(argv, init, monkeypatch):
    """The port's CLI in this process, its state built from ``init``."""
    real = cli.create_sharded_state
    monkeypatch.setattr(cli, "create_sharded_state", lambda model, opt, mesh, seed=0: real(
        model, opt, mesh, init_params=init, seed=seed))
    return cli.main(argv + ["--device=cpu"])


def assert_matches_jax(res, want, learns=True):
    """``res`` ends where the JAX CLI's run ``want`` ends; with ``learns``,
    that run has learned (the synthetic data's planted signal) so that a
    port step that does not learn cannot match it."""
    assert res["steps"] == want["steps"] > 0
    assert res["eval"]["count"] == want["eval"]["count"] > 0
    if learns:
        assert want["eval"]["auc"] > 0.52
    for k in ("auc", "logloss"):
        np.testing.assert_allclose(res["eval"][k], want["eval"][k], **METRIC_TOL)


def _same_tree(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same_tree(a[k], b[k])
    else:
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' runs, and the JAX CLI's on the same arguments."""
    io_dir = str(tmp_path_factory.mktemp("cli"))
    ck = os.path.join(io_dir, "ck")
    want = dict(zip(("sparse_row", "auto_capacity", "uninterrupted"),
                    jax_runs([SPARSE_ROW, AUTO_CAPACITY, FM_TWO_EPOCHS], io_dir)))
    fm_init = want["uninterrupted"][1]
    cpu = ["--device=cpu"]
    runs = [("sparse_row", SPARSE_ROW + cpu, want["sparse_row"][1]),
            ("auto_capacity", AUTO_CAPACITY + cpu, want["auto_capacity"][1]),
            ("first", FM + cpu + [f"--config.train.checkpoint_dir={ck}"], fm_init),
            ("resumed", FM_TWO_EPOCHS + cpu + [f"--config.train.checkpoint_dir={ck}"],
             fm_init),
            ("uninterrupted", FM_TWO_EPOCHS + cpu, fm_init)]
    # each flag's run and the same run without it, from the CLI's own seeded
    # state
    for flag, argv in FLAG_RUNS.items():
        runs += [(flag, argv + [flag] + cpu, None), (f"{flag} unflagged", argv + cpu, None)]
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump({"runs": runs}, f)
    spawn(worker.cli_cases, RANKS, (io_dir,), store_dir=io_dir)
    out = {}
    for r in range(RANKS):
        with open(os.path.join(io_dir, f"results_{r}.pkl"), "rb") as f:
            out[r] = pickle.load(f)
    return out, ck, {k: v[0] for k, v in want.items()}


def test_cli_builds_the_reference_data():
    cfg, _ = cli.parse_args(SYNTH)
    jcfg = japply(JConfig(), SYNTH)
    fs, data = cli.build_data(cfg)
    jfs, jdata = jcli.build_data(jcfg)
    assert fs.fingerprint == jfs.fingerprint
    _same_tree(data, jdata)


def test_cli_synthetic_train_eval(tmp_path, monkeypatch):
    want, init = jax_run(SYNTH, str(tmp_path))
    res = port_run(SYNTH, init, monkeypatch)
    assert_matches_jax(res, want)
    assert np.isfinite(res["train"]["logloss"])


def test_cli_stream_source(tmp_path, monkeypatch):
    from ml_function_tpu_torch.features.native_loader import native_available
    if not native_available():
        pytest.skip("g++ toolchain unavailable")
    rng = np.random.default_rng(0)

    def mk(path, rows):
        lines = []
        for _ in range(rows):
            fields = ([str(rng.integers(0, 2))] + [str(rng.integers(0, 40)) for _ in range(3)]
                      + [f"v{rng.integers(0, 30)}" for _ in range(4)])
            lines.append("\t".join(fields))
        path.write_text("\n".join(lines) + "\n")

    train_p, eval_p = tmp_path / "train.tsv", tmp_path / "eval.tsv"
    mk(train_p, 600)
    mk(eval_p, 128)
    argv = ["--config.model.name=deepfm", "--config.model.hidden=(16,8)",
            "--config.data.source=stream", f"--config.data.path={train_p}",
            f"--config.data.eval_path={eval_p}", "--config.data.n_dense=3",
            "--config.data.n_sparse=4", "--config.data.hash_buckets=256",
            "--config.train.batch_size=64", "--config.train.log_every=0"]
    want, init = jax_run(argv, str(tmp_path))
    res = port_run(argv, init, monkeypatch)
    assert res["steps"] == 600 // 64
    assert res["eval"]["count"] == 128
    assert_matches_jax(res, want, learns=False)      # random rows: no signal
    assert np.isfinite(res["train"]["logloss"])


def test_cli_sparse_row_optimizer(ranks):
    """``train.row_optimizer`` routes the CLI through the sharded sparse-row
    path on a (2, 2) mesh: every rank reports the same global result, the
    JAX CLI's."""
    out, _, want = ranks
    res = out[0]["sparse_row"]
    for k in ("train", "eval", "steps"):       # the rates are each rank's clock
        assert all(res[k] == out[r]["sparse_row"][k] for r in range(1, RANKS))
    assert_matches_jax(res, want["sparse_row"])
    assert np.isfinite(res["train"]["logloss"])


def test_cli_auto_capacity_runs(ranks):
    """``mesh.capacity=auto`` plans a lossless capacity: the a2a run ends
    where the JAX CLI's does."""
    out, _, want = ranks
    assert_matches_jax(out[0]["auto_capacity"], want["auto_capacity"])


def test_cli_resumes_from_its_sharded_checkpoint(ranks):
    """Four ranks write sharded checkpoints; a second run resumes from the
    newest at the first run's last step and ends where an uninterrupted run
    ends, which ends where the JAX CLI's does."""
    out, ck, want = ranks
    first, resumed, whole = (out[0][k] for k in ("first", "resumed", "uninterrupted"))
    assert resumed["steps"] == whole["steps"] == 2 * first["steps"]
    for k in ("auc", "logloss"):
        np.testing.assert_allclose(resumed["eval"][k], whole["eval"][k], rtol=1e-6)
    assert_matches_jax(whole, want["uninterrupted"])
    newest = sorted(d for d in os.listdir(ck) if d.startswith("ckpt_"))[-1]
    with open(os.path.join(ck, newest, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["format"] == "sharded" and manifest["mesh"] == [2, 2]
    assert int(newest.split("_")[1]) == whole["steps"]


def test_cli_checkpoint_rejects_layout_mismatch(tmp_path):
    """A checkpoint stamped with another table layout's fingerprint (same
    shapes, rows permuted) fails loudly on resume."""
    args = ["--config.model.name=fm", "--config.data.n_rows=256",
            "--config.data.vocab_size=50", "--config.train.batch_size=64",
            "--config.train.log_every=0", f"--config.train.checkpoint_dir={tmp_path}",
            "--device=cpu"]
    cli.main(args)
    a = FeatureSet(sparse=(SparseSpec("x", 10, dim=4), SparseSpec("y", 20, dim=4)))
    b = a.replace(vocab_layout=(("y", 0), ("x", 20)))
    assert a.total_vocab == b.total_vocab and a.fingerprint != b.fingerprint
    ck = sorted(os.listdir(tmp_path))[-1]
    man_path = tmp_path / ck / "manifest.json"
    man = json.loads(man_path.read_text())
    man["extra"]["fs_fingerprint"] = "deadbeefdeadbeef"
    man_path.write_text(json.dumps(man))
    with pytest.raises(ValueError, match="different table layout"):
        cli.main(args)


@pytest.mark.parametrize("flag", ["--config.mesh.seq_shard=true",
                                  "--config.mesh.pp_microbatches=2"])
def test_cli_seq_shard_and_pipeline_flags(ranks, flag):
    """The reference's sequence-sharded search and pipeline flags reach the
    sharded step on a (2, 2) mesh (SIM's search split over the model axis,
    AutoInt's blocks as two stages): every rank reports the same global
    result, and the run ends where the same run without the flag ends (the
    flag changes the route, not the result: the same steps and eval rows,
    AUC and logloss within 1e-5). The routes' steps are held to the JAX
    package's in ``test_torch_seq_parallel.py`` and ``test_torch_gpipe.py``."""
    out, _, _ = ranks
    res, plain = out[0][flag], out[0][f"{flag} unflagged"]
    for k in ("train", "eval", "steps"):
        assert all(res[k] == out[r][flag][k] for r in range(1, RANKS))
    assert res["steps"] == plain["steps"] > 0
    assert res["eval"]["count"] == plain["eval"]["count"] > 0
    for k in ("auc", "logloss"):
        np.testing.assert_allclose(res["eval"][k], plain["eval"][k], rtol=0, atol=1e-5)
    assert np.isfinite(res["train"]["logloss"])
