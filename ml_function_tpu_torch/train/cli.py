"""The command-line train and eval entry of the port.

Counterpart of ``ml_function_tpu/train/cli.py``: every run joins the
process group (``init_multihost``, a no-op for one process), builds the
``(data, model)`` mesh and a sharded state (or a sparse-row sharded state
with ``train.row_optimizer``), resumes from the newest readable checkpoint
after checking the table layout's fingerprint, and trains with the
periodic eval, the early stop and the best-checkpoint keep of
``train/control.py``.

    python -m ml_function_tpu_torch.train.cli --device=cpu \
        --config.model.name=deepfm --config.train.batch_size=4096
    torchrun --nproc_per_node=2 -m ml_function_tpu_torch.train.cli \
        --device=cpu --config.mesh.model=2 --config.train.checkpoint_dir=ck

``--device`` is the port's own flag (default: the card, one a rank, with
NCCL; ``cpu`` runs on gloo). ``mesh.seq_shard`` and ``mesh.pp_microbatches``
reach the sharded train step (and ``seq_shard`` the eval), as in the
reference; the sparse-row path takes neither, as there.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..features.synthetic import make_behavior_data, make_criteo_like
from ..models import get_model
from ..parallel import comm
from ..parallel.mesh import MODEL_AXIS, make_mesh
from ..parallel.multihost import global_metrics, init_multihost
from ..parallel.train import (create_sharded_state, evaluate_sharded,
                              make_sharded_train_step, shard_batch)
from ..utils.debug import enable_nan_checks, profile
from .checkpoint import restore_latest, save_checkpoint
from .config import Config, apply_overrides
from .loop import iter_batches, prefetch, train_test_split
from .metrics import init_metrics, metrics_summary, update_metrics
from .optimizers import make_optimizer

NO_HIDDEN = ("fm", "afm", "seqfm", "sim", "mimn", "dts", "autoint", "lr")


def build_data(cfg: Config):
    """``(FeatureSet, data or None)`` as the reference's ``build_data``:
    synthetic, csv, and the out-of-core stream and behavior_stream sources
    (their schema fixed by the hash spaces; batches come from
    ``stream_iter``)."""
    d = cfg.data
    if d.source == "synthetic":
        if d.seq_len > 0:
            return make_behavior_data(n_rows=d.n_rows, seq_len=d.seq_len,
                                      embed_dim=cfg.model.embed_dim, seed=cfg.train.seed)
        return make_criteo_like(n_rows=d.n_rows, n_dense=d.n_dense, n_sparse=d.n_sparse,
                                vocab_size=d.vocab_size, embed_dim=cfg.model.embed_dim,
                                seed=cfg.train.seed)
    if d.source == "csv":
        from ..features.pipeline import criteo_csv_pipeline
        return criteo_csv_pipeline(d.path, n_dense=d.n_dense, n_sparse=d.n_sparse,
                                   embed_dim=cfg.model.embed_dim,
                                   hash_features=d.hash_features)
    if d.source == "stream":
        from ..features.schema import criteo_feature_set
        return criteo_feature_set([d.hash_buckets] * d.n_sparse, n_dense=d.n_dense,
                                  embed_dim=cfg.model.embed_dim), None
    if d.source == "behavior_stream":
        from ..features.behavior_stream import behavior_stream_feature_set
        return behavior_stream_feature_set(
            item_buckets=d.hash_buckets, cate_buckets=d.cate_buckets,
            seq_len=d.seq_len or 90, embed_dim=cfg.model.embed_dim,
            long_seq_len=d.long_seq_len), None
    raise ValueError(f"unknown data source {d.source!r}")


def stream_iter(cfg: Config, mesh):
    """This rank's batches of a stream source: the data coordinate's
    disjoint chunks (the model ranks of one group read the same ones), in
    batches of ``batch_size / data`` rows."""
    shard = (mesh.data_index, mesh.data) if mesh.data > 1 else None
    per = cfg.train.batch_size // mesh.data
    if cfg.data.source == "behavior_stream":
        from ..features.behavior_stream import BehaviorFileIterator
        return iter(BehaviorFileIterator(
            cfg.data.path, per, seq_len=cfg.data.seq_len or 90,
            long_seq_len=cfg.data.long_seq_len, item_buckets=cfg.data.hash_buckets,
            cate_buckets=cfg.data.cate_buckets, chunk_bytes=cfg.data.chunk_mb << 20,
            shard=shard))
    from ..features.native_loader import CriteoFileIterator
    return iter(CriteoFileIterator(
        cfg.data.path, per, n_dense=cfg.data.n_dense, n_sparse=cfg.data.n_sparse,
        hash_buckets=cfg.data.hash_buckets, chunk_bytes=cfg.data.chunk_mb << 20,
        shard=shard))


def _eval_data(cfg: Config):
    if not cfg.data.eval_path:
        return None
    if cfg.data.source == "behavior_stream":
        from ..features.behavior_stream import load_behavior_stream
        return load_behavior_stream(
            cfg.data.eval_path, embed_dim=cfg.model.embed_dim,
            seq_len=cfg.data.seq_len or 90, long_seq_len=cfg.data.long_seq_len,
            item_buckets=cfg.data.hash_buckets, cate_buckets=cfg.data.cate_buckets)[1]
    from ..features.native_loader import load_criteo
    return load_criteo(cfg.data.eval_path, n_dense=cfg.data.n_dense,
                       n_sparse=cfg.data.n_sparse, hash_buckets=cfg.data.hash_buckets)


def _all_have(has: bool, mesh) -> bool:
    """Whether every rank still has a batch (the stream shards may end at
    different steps; every rank stops at the first that ends)."""
    if not (dist.is_available() and dist.is_initialized()):
        return has
    flag = torch.tensor([1 if has else 0], device=mesh.device)
    return bool(comm.all_min(flag, dist.group.WORLD).item())


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cfg: Config, device=None,
        on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
    """Train and evaluate as ``cfg`` says; returns the result dict
    (``train``, ``eval``, ``steps``, ``examples_per_sec`` and, with the
    periodic eval, ``stopped_early``, ``best_step``, ``best_<monitor>``),
    printed by rank 0. ``on_step(step, out)`` sees each train step's output
    (its ``loss`` is the global batch's)."""
    init_multihost(device=device)
    if cfg.train.debug_nans:
        enable_nan_checks(True)
    mesh = make_mesh(cfg.mesh.data or None, cfg.mesh.model, device=device)
    rank0 = mesh.coords == (0, 0)

    fs, data = build_data(cfg)
    if data is None:
        train_data, test_data = None, _eval_data(cfg)
    else:
        train_data, test_data = train_test_split(data, cfg.data.test_frac,
                                                 seed=cfg.train.seed)
    hp = dict(cfg.model.extra)
    if cfg.model.name not in NO_HIDDEN:
        hp.setdefault("hidden", tuple(cfg.model.hidden))
    hp = {k: tuple(v) if isinstance(v, list) else v for k, v in hp.items()}
    # the whole model in host memory from the seed; each rank keeps its
    # blocks (parallel/train.py, ROADMAP.md D5)
    model = get_model(cfg.model.name, fs, device="cpu",
                      generator=torch.Generator().manual_seed(cfg.train.seed), **hp)
    opt = make_optimizer(cfg.train.optimizer, cfg.train.learning_rate,
                         schedule=cfg.train.lr_schedule,
                         decay_steps=cfg.train.lr_decay_steps,
                         warmup_steps=cfg.train.lr_warmup_steps)
    if cfg.train.row_optimizer:
        from ..parallel.sparse import create_sparse_sharded_state
        from .sparse import make_row_optimizer
        ts = create_sparse_sharded_state(
            model, opt, make_row_optimizer(cfg.train.row_optimizer,
                                           cfg.train.row_learning_rate), mesh)
    else:
        ts = create_sharded_state(model, opt, mesh, seed=cfg.train.seed)

    start_step = 0
    if cfg.train.checkpoint_dir:
        ts2, extra, ck = restore_latest(cfg.train.checkpoint_dir, ts)
        if ck:
            saved_fp = extra.get("fs_fingerprint")
            if saved_fp and saved_fp != fs.fingerprint:
                raise ValueError(
                    f"checkpoint {ck} was written for a different table layout "
                    f"(fingerprint {saved_fp} != current {fs.fingerprint}); "
                    "restoring would silently permute vocab rows — rebuild the "
                    "FeatureSet (same planner layout) or start a fresh checkpoint_dir")
            ts = ts2
            start_step = int(ts.step)
            _log(f"resumed from {ck} at step {start_step}")

    compress = cfg.mesh.compress or None

    def resolve_capacity(setting: str, tag: str):
        if not setting:
            return None
        if setting == "auto":
            from ..parallel.planner import plan_capacity
            per_dev = cfg.train.batch_size // mesh.data
            # one capacity serves every a2a lookup of the step, so it covers
            # the largest: the sum over all lookups bounds each one
            ids_per_ex = max(len(fs.sparse), 1) + sum(s.max_len for s in fs.seq)
            cap = plan_capacity(fs, mesh.shape[MODEL_AXIS], per_dev * ids_per_ex)
            _log(f"{tag} auto capacity: {cap} (per-device ids {per_dev * ids_per_ex})")
            return cap
        return int(setting)

    if cfg.train.row_optimizer:
        from ..parallel.sparse import make_sparse_sharded_train_step
        train_step = make_sparse_sharded_train_step(
            ts, exchange=cfg.mesh.exchange, compress=compress,
            grad_exchange=cfg.mesh.grad_exchange,
            grad_capacity=(resolve_capacity(cfg.mesh.grad_capacity, "grad-a2a")
                           if cfg.mesh.grad_exchange == "a2a" else None))
    else:
        train_step = make_sharded_train_step(
            ts.model, ts.optimizer, mesh, exchange=cfg.mesh.exchange,
            compress=compress,
            capacity=(resolve_capacity(cfg.mesh.capacity, "a2a")
                      if cfg.mesh.exchange == "a2a" else None),
            seq_shard=cfg.mesh.seq_shard, pp_microbatches=cfg.mesh.pp_microbatches)

    def eval_now():
        return evaluate_sharded(ts.model, mesh, test_data, cfg.train.batch_size,
                                exchange=cfg.mesh.exchange, compress=compress,
                                seq_shard=cfg.mesh.seq_shard)

    # under a process group (torchrun, or a FileStore of one rank) every rank
    # writes its blocks: the sharded format, whatever the world size
    fmt = "sharded" if dist.is_available() and dist.is_initialized() else None

    def save(path, keep=3, **more):
        save_checkpoint(path, ts, keep=keep, format=fmt,
                        extra={"config": cfg.to_json(),
                               "fs_fingerprint": fs.fingerprint, **more})

    # every rank runs the same host logic on the same merged metric, so the
    # decisions stay in lockstep
    stopper = best_tracker = None
    can_eval = cfg.train.eval_every > 0 and test_data is not None
    if can_eval:
        from .control import EarlyStopping, MetricMonitor
        best_tracker = MetricMonitor(cfg.train.monitor, min_delta=cfg.train.min_delta)
        if cfg.train.patience:
            stopper = EarlyStopping(cfg.train.patience, cfg.train.monitor,
                                    min_delta=cfg.train.min_delta)

    metrics = init_metrics(device=mesh.device)
    step_i, t0, n_seen = 0, None, 0
    stopped = False
    with profile(cfg.train.profile_dir):
        for epoch in range(cfg.train.epochs):
            if train_data is None:
                epoch_iter = stream_iter(cfg, mesh)
            else:
                epoch_iter = (shard_batch(b, mesh) for b in iter_batches(
                    train_data, cfg.train.batch_size, shuffle=True,
                    seed=cfg.train.seed + epoch))
            it = prefetch(epoch_iter)
            while True:
                batch = next(it, None)
                if train_data is None and not _all_have(batch is not None, mesh):
                    break
                if batch is None:
                    break
                if step_i < start_step:
                    step_i += 1
                    continue   # fast-forward the data on resume
                out = train_step(batch)
                ts.step = step_i + 1
                if on_step is not None:
                    on_step(step_i + 1, out)
                metrics = update_metrics(metrics, out["logits"], out["label"],
                                         out["weight"])
                step_i += 1
                if step_i == start_step + 1:
                    if mesh.device.type == "cuda":
                        torch.cuda.synchronize(mesh.device)
                    t0 = time.perf_counter()
                else:
                    n_seen += cfg.train.batch_size
                if cfg.train.log_every and step_i % cfg.train.log_every == 0 and rank0:
                    ov = (f" a2a_overflow {int(out['a2a_overflow'])}"
                          if "a2a_overflow" in out else "")
                    _log(f"step {step_i} loss {float(out['loss']):.4f}{ov}")
                if (cfg.train.checkpoint_dir and cfg.train.checkpoint_every
                        and step_i % cfg.train.checkpoint_every == 0):
                    save(cfg.train.checkpoint_dir)
                if can_eval and step_i % cfg.train.eval_every == 0:
                    summ = eval_now()
                    if rank0:
                        _log(f"eval @ step {step_i}: {summ}")
                    if best_tracker.improved(summ[cfg.train.monitor], step_i):
                        if cfg.train.save_best and cfg.train.checkpoint_dir:
                            save(os.path.join(cfg.train.checkpoint_dir, "best"), keep=1,
                                 **{cfg.train.monitor: summ[cfg.train.monitor]})
                    if stopper is not None and stopper.update(summ[cfg.train.monitor],
                                                              step_i):
                        if rank0:
                            _log(f"early stop @ step {step_i} (best {cfg.train.monitor}="
                                 f"{stopper.best:.5f} @ step {stopper.best_step})")
                        stopped = True
                        break
            if stopped:
                break
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dt = (time.perf_counter() - t0) if t0 else 0.0

    if cfg.train.checkpoint_dir:
        save(cfg.train.checkpoint_dir)

    result = {"train": metrics_summary(global_metrics(metrics, mesh)),
              "eval": (eval_now() if test_data is not None
                       else metrics_summary(init_metrics())),
              "steps": step_i,
              "examples_per_sec": (n_seen / dt) if dt > 0 else 0.0}
    if test_data is not None and "group" in test_data and mesh.size == 1:
        # a group key: GAUC and calibration beside the AUC (one rank: the
        # per-example probabilities stay on it)
        from .loop import evaluate
        full = evaluate(ts.model, test_data, batch_size=cfg.train.batch_size)
        result["eval"].update({k: full[k] for k in ("gauc", "gauc_groups", "ratio", "ece")
                               if k in full})
    if can_eval:
        result["stopped_early"] = stopped
        result["best_step"] = best_tracker.best_step
        result["best_" + cfg.train.monitor] = best_tracker.best
    comm.barrier()
    if rank0:
        print(result)
    return result


def parse_args(argv: Sequence[str]):
    """``(Config, device)`` from ``--config.a.b=v`` overrides and the
    port's ``--device=...``."""
    device: Optional[str] = None
    rest = []
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            rest.append(arg)
    return apply_overrides(Config(), rest), device


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg, device = parse_args(argv)
    _log(cfg.to_json())
    return run(cfg, device=device)


if __name__ == "__main__":
    main()
