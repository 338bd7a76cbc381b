"""The port's multi-process helpers (``parallel/multihost.py``): the cases of
``tests/test_utils_multihost.py``, one process here against the JAX
package's helpers, and a (2, 2) mesh of 4 gloo ranks (one spawn for the
file, ``torch_parallel_worker.multihost_cases``), where a rank's rows are
its data coordinate's block and the merged metrics are the whole batch's.

Bars: the merged histograms and counts equal the one-process metrics of the
whole batch exactly (sums of 0/1 weights); the loss sum within 1e-6
(summed in another order).
"""

import os
import pickle
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from ml_function_tpu.parallel import multihost as jmh
from ml_function_tpu.train.metrics import init_metrics as jax_init_metrics
from ml_function_tpu.train.metrics import update_metrics as jax_update_metrics
from ml_function_tpu_torch.parallel.launch import spawn
from ml_function_tpu_torch.parallel.multihost import (Heartbeat, global_metrics,
                                                      host_batch_slice, init_multihost)
from ml_function_tpu_torch.train.metrics import init_metrics, update_metrics

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("multihost"))
    rng = np.random.default_rng(0)
    inputs = {"logits": rng.normal(size=64).astype(np.float32),
              "labels": rng.integers(0, 2, 64).astype(np.float32)}
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    spawn(worker.multihost_cases, 4, (io_dir,), store_dir=io_dir)
    out = {}
    for r in range(4):
        with open(os.path.join(io_dir, f"results_{r}.pkl"), "rb") as f:
            out[r] = pickle.load(f)
    return inputs, out


def test_init_multihost_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert init_multihost(device="cpu") == (0, 1) == tuple(jmh.init_multihost())


def test_host_batch_slice_single():
    assert host_batch_slice(128) == (0, 128) == tuple(jmh.host_batch_slice(128))


def test_global_metrics_single_host_identity():
    m = update_metrics(init_metrics(), torch.tensor([1.0, -1.0]), torch.tensor([1.0, 0.0]))
    g = global_metrics(m)
    jg = jmh.global_metrics(jax_update_metrics(jax_init_metrics(), jnp.asarray([1.0, -1.0]),
                                               jnp.asarray([1.0, 0.0])))
    assert float(g["count"]) == float(jg["count"]) == 2.0
    np.testing.assert_array_equal(g["pos_hist"].numpy(), np.asarray(jg["pos_hist"]))


def test_heartbeat(tmp_path):
    hb = Heartbeat(str(tmp_path), interval_s=0.0, timeout_s=0.2)
    hb.beat(step=1)
    assert hb.stale_hosts() == []
    time.sleep(0.3)
    assert hb.stale_hosts() == [0]
    with pytest.raises(RuntimeError, match="checkpoint-restart"):
        hb.check_or_raise()


def test_heartbeat_flags_never_beat_host(tmp_path, monkeypatch):
    """A rank that never wrote a beat is stale once the monitor's own grace
    period has passed; a torn beat file falls back to its mtime."""
    from ml_function_tpu_torch.parallel import multihost as mh
    monkeypatch.setattr(mh, "process_count", lambda: 2)
    hb = Heartbeat(str(tmp_path), interval_s=0.0, timeout_s=0.2)
    hb.beat()
    (tmp_path / "host_1.hb").write_text("{torn")
    assert hb.stale_hosts() == []
    os.remove(tmp_path / "host_1.hb")
    time.sleep(0.3)
    hb._last_beat = 0.0
    hb.beat()
    assert hb.stale_hosts() == [1]


def test_rank_rows_are_the_data_coordinate_block(ranks):
    """Rank r sits at (r // 2, r % 2); the ranks of one model group feed the
    same rows; init_multihost reports the group it joined."""
    _, out = ranks
    for r, res in out.items():
        assert res["coords"] == divmod(r, 2)
        assert res["slice"] == (32 * (r // 2), 32)
        assert res["init"] == (r, 4)


def test_global_metrics_sum_over_the_data_group(ranks):
    """Each rank's metrics of its rows, summed over the data group only,
    equal the metrics of the whole batch on every rank."""
    inputs, out = ranks
    want = update_metrics(init_metrics(), torch.tensor(inputs["logits"]),
                          torch.tensor(inputs["labels"]))
    for res in out.values():
        for k in ("pos_hist", "neg_hist", "count"):
            np.testing.assert_array_equal(res["metrics"][k], want[k].numpy(), err_msg=k)
        np.testing.assert_allclose(res["metrics"]["loss_sum"], want["loss_sum"].numpy(),
                                   rtol=1e-6)


def test_heartbeat_files_a_rank(ranks):
    _, out = ranks
    for res in out.values():
        assert res["beat"] and res["stale"] == []


def test_elastic_recovery_drill(tmp_path):
    """Checkpoint-restart on one rank: 2 sharded steps, a checkpoint, a
    heartbeat that goes stale raises, the restarted job restores the newest
    checkpoint at step 2 and its next 2 steps give the uninterrupted run's
    parameters bit for bit."""
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.parallel.mesh import make_mesh
    from ml_function_tpu_torch.parallel.train import (create_sharded_state,
                                                      make_sharded_train_step)
    from ml_function_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                        restore_checkpoint,
                                                        save_checkpoint)
    from ml_function_tpu_torch.train.loop import iter_batches
    from ml_function_tpu_torch.train.optimizers import make_optimizer
    fs, data = make_criteo_like(n_rows=128, n_dense=2, n_sparse=4, vocab_size=16,
                                embed_dim=4, seed=0)
    batches = list(iter_batches(data, 32))
    mesh = make_mesh(device="cpu")

    def state():
        ts = create_sharded_state(get_model("fm", fs, device="cpu"),
                                  make_optimizer("adam", 1e-2), mesh)
        return ts, make_sharded_train_step(ts.model, ts.optimizer, mesh)

    ref, step = state()
    for b in batches:
        step(b)
    ts, step = state()
    for b in batches[:2]:
        step(b)
    ts.step = 2
    save_checkpoint(str(tmp_path / "ck"), ts)
    hb = Heartbeat(str(tmp_path / "hb"), interval_s=0.0, timeout_s=0.05)
    hb.beat(step=2)
    time.sleep(0.1)
    with pytest.raises(RuntimeError, match="checkpoint-restart"):
        hb.check_or_raise()
    ts2, step2 = state()
    ts2, _ = restore_checkpoint(latest_checkpoint(str(tmp_path / "ck")), ts2)
    assert ts2.step == 2
    for b in batches[2:]:
        step2(b)
    for (n, a), (_, b) in zip(ref.model.named_parameters(), ts2.model.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy(), err_msg=n)
