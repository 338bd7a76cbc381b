"""Collective accounting of the sharded step on CPU gloo ranks, and the
weak-scaling efficiency it projects on NVLink.

    python3 -m ml_function_tpu_torch.tools.scaling_report \\
        [--step-ms xdeepfm=MS --step-ms deepfm=MS] [--batch-per-rank 4096] \\
        [--vocab 2000] [--meshes 2x2,4x2,8x2] [--latency-ms MS] [--out FILE]

Counterpart of ``examples/scaling_report.py``. For each mesh (data ×
model) it spawns that many CPU gloo ranks (``parallel/launch.spawn``, one
thread a rank); each rank records ONE step of each configuration
(``utils/hlo_stats.collective_stats``) and rank 0 writes the records:

- DeepFM (hidden (256, 128, 64)) and xDeepFM (CIN (128, 128), MLP
  (256, 128)) at the Criteo schema (13 dense, 26 fields, dim 8), each with
  the exchanges psum, a2a and psum with bf16 rows;
- the sparse-row backward of DeepFM (row Adagrad), allgather against a2a
  at the lossless capacity.

A mesh runs only where the host has a core a rank (8 × 2 needs 16).

The payloads of the lookups depend on the batch, the fields and the dim,
so the ranks take the per-rank batch of the card's step time (``chip_smoke``
phase 27 (a): B 4096) and a small vocabulary (2,000 ids a field) on the
reference's principle. One payload does depend on the vocabulary: the dense
step sums every parameter's gradient over the data group, this rank's
blocks of the tables among them (``parallel/train.sync_grads``; the
reference's compiled tuple holds them too). Each row prints those bytes
apart (``table_grad_bytes``); ``--vocab 100000`` records the Criteo width's.

The projection takes each model's step time on one card from ``--step-ms``
(chip_smoke phase 27 (a) prints it) and the NVLink model of
``utils/hlo_stats.LinkModel`` (data-sheet rate; ``--latency-ms`` sets the
call floor, phase 27 (c)). A model without a step time gets no projection.
It prints a JSON line a configuration, then the tables.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

N_DENSE, N_SPARSE, DIM = 13, 26, 8
HP = {"deepfm": {"hidden": (256, 128, 64)},
      "xdeepfm": {"cin_hidden": (128, 128), "hidden": (256, 128)}}
EXCHANGES = (("psum", None), ("a2a", None), ("psum", "bf16"))
SPARSE = (("allgather", None), ("a2a", None))


def configs() -> List[dict]:
    out = [{"model": m, "exchange": e, "compress": c} for m in ("deepfm", "xdeepfm")
           for e, c in EXCHANGES]
    out += [{"model": "deepfm", "exchange": "psum", "compress": None,
             "row_optimizer": "adagrad", "grad_exchange": g, "grad_capacity": cap}
            for g, cap in SPARSE]
    return out


def record_step(cfg: dict, mesh, batch_per_rank: int, fs, hp: dict) -> dict:
    """One recorded step of ``cfg`` (model, exchange, compress and, for the
    sparse-row step, row optimizer, gradient exchange and capacity) on this
    rank, the model built on ``fs`` with widths ``hp``, the batch's features
    all ones: its collectives' kinds, bytes, wire bytes, the sizes of the
    parameters whose gradients the step sums over the data group (this
    rank's blocks of the tables among them, but for the sparse-row step's
    row tables) and the table blocks' gradient bytes in that sum."""
    import numpy as np
    import torch

    from ..models import get_model
    from ..parallel.sparse import (create_sparse_sharded_state,
                                   make_sparse_sharded_train_step, sharded_row_groups)
    from ..parallel.train import create_sharded_state, make_sharded_train_step, shard_batch
    from ..train.optimizers import make_optimizer
    from ..train.sparse import make_row_optimizer, sparse_dense_tree
    from ..utils.hlo_stats import collective_stats

    model = get_model(cfg["model"], fs, device="cpu",
                      generator=torch.Generator().manual_seed(0), **hp)
    opt = make_optimizer("adam", 1e-3)
    b = batch_per_rank * mesh.data
    batch = {"dense": np.zeros((b, len(fs.dense)), np.float32),
             "sparse": np.ones((b, len(fs.sparse)), np.int32),
             "label": np.zeros((b,), np.float32), "weight": np.ones((b,), np.float32)}
    if cfg.get("row_optimizer"):
        ts = create_sparse_sharded_state(model, opt, make_row_optimizer(cfg["row_optimizer"]),
                                         mesh)
        step = make_sparse_sharded_train_step(ts, exchange=cfg["exchange"],
                                              compress=cfg.get("compress"),
                                              grad_exchange=cfg["grad_exchange"],
                                              grad_capacity=cfg.get("grad_capacity"))
        synced = {n for n, _ in sparse_dense_tree(ts.model,
                                                  sharded_row_groups(ts.model, ts.layout))}
    else:
        ts = create_sharded_state(model, opt, mesh)
        step = make_sharded_train_step(ts.model, ts.optimizer, mesh,
                                       exchange=cfg["exchange"], compress=cfg.get("compress"))
        synced = {n for n, _ in ts.model.named_parameters()}
    stats = collective_stats(step, shard_batch(batch, mesh))
    synced_params = [(n, p) for n, p in ts.model.named_parameters() if n in synced]
    table_grad = (sum(p.numel() * p.element_size() for n, p in synced_params
                      if n in ts.layout) if mesh.data > 1 else 0)
    by_group: Dict[str, int] = {}
    for i in stats.instrs:
        by_group[i.group] = by_group.get(i.group, 0) + i.bytes
    return {**cfg, "data": mesh.data, "model_axis": mesh.model,
            "n_ranks": mesh.size, "batch_per_rank": batch_per_rank,
            "counts": stats.counts, "bytes": stats.bytes, "bytes_by_group": by_group,
            "total_count": stats.total_count, "total_bytes": stats.total_bytes,
            "wire_bytes": stats.wire_bytes(), "table_grad_bytes": table_grad,
            "synced_numels": sorted(p.numel() for _, p in synced_params),
            "records": [[i.op, i.bytes, i.group_size, i.group, i.dtype]
                        for i in stats.instrs]}


def _rank(rank: int, io_dir: str, shape: tuple, batch_per_rank: int, vocab: int,
          cfgs: list) -> None:
    from ..features.schema import criteo_feature_set
    from ..parallel.mesh import make_mesh

    mesh = make_mesh(*shape, device="cpu")
    fs = criteo_feature_set([vocab] * N_SPARSE, n_dense=N_DENSE, embed_dim=DIM)
    rows = [{**record_step(c, mesh, batch_per_rank, fs, HP[c["model"]]), "vocab": vocab}
            for c in cfgs]
    if rank == 0:
        with open(os.path.join(io_dir, "records.json"), "w") as f:
            json.dump(rows, f)


def probe(shape: tuple, batch_per_rank: int, vocab: int, cfgs: list) -> List[dict]:
    """Every configuration's records on a ``shape`` mesh of CPU gloo ranks."""
    from ..parallel.launch import spawn
    # by its package name, not ``__main__``'s, for the spawned ranks
    from . import scaling_report

    with tempfile.TemporaryDirectory() as io_dir:
        spawn(scaling_report._rank, shape[0] * shape[1],
              (io_dir, shape, batch_per_rank, vocab, cfgs), store_dir=io_dir)
        with open(os.path.join(io_dir, "records.json")) as f:
            return json.load(f)


def project(row: dict, step_ms: Optional[float], link) -> dict:
    """The row's communication time under ``link`` and, with the card's
    step time, its efficiency exposed and at 50% overlap."""
    from ..utils.hlo_stats import projected_efficiency

    out = {"t_comm_ms": 1e3 * link.comm_s(row["wire_bytes"], row["total_count"]),
           "step_ms": step_ms}
    for overlap, tag in ((0.0, "eff_exposed"), (0.5, "eff_50")):
        out[tag] = (None if step_ms is None else projected_efficiency(
            step_ms * 1e-3, row["wire_bytes"], row["total_count"], link,
            overlap=overlap)["efficiency"])
    return out


def _pct(x) -> str:
    return "not measured" if x is None else f"{x:.2%}"


def table(rows: List[dict]) -> str:
    lines = ["| model | ranks (d×m) | exchange | collectives | wire MB/step | of it the "
             "table gradient MB | t_comm ms | card step ms | eff (exposed) | "
             "eff (50% overlap) |", "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("row_optimizer"):
            continue
        k = r["data"]
        tg = 2 * (k - 1) / k * r["table_grad_bytes"]
        lines.append(
            f"| {r['model']} | {r['n_ranks']} ({r['data']}×{r['model_axis']}) | "
            f"{r['exchange']}{'+bf16' if r['compress'] else ''} | {r['total_count']} | "
            f"{r['wire_bytes'] / 1e6:.3f} | {tg / 1e6:.3f} | {r['t_comm_ms']:.4f} | "
            f"{r['step_ms'] if r['step_ms'] is not None else 'not measured'} | "
            f"{_pct(r['eff_exposed'])} | {_pct(r['eff_50'])} |")
    lines += ["", "sparse-row backward (DeepFM, row Adagrad, lossless capacity):", "",
              "| grad exchange | ranks (d×m) | collectives | counts | wire MB/step | "
              "t_comm ms |", "|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("row_optimizer"):
            lines.append(f"| {r['grad_exchange']} | {r['n_ranks']} ({r['data']}×"
                         f"{r['model_axis']}) | {r['total_count']} | "
                         f"{json.dumps(r['counts'], sort_keys=True)} | "
                         f"{r['wire_bytes'] / 1e6:.3f} | {r['t_comm_ms']:.4f} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    from ..utils.hlo_stats import LinkModel

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step-ms", action="append", default=[],
                    help="MODEL=MS: the model's step time on one card")
    ap.add_argument("--batch-per-rank", type=int, default=4096)
    ap.add_argument("--vocab", type=int, default=2000)
    ap.add_argument("--meshes", default="2x2,4x2,8x2")
    ap.add_argument("--latency-ms", type=float, default=None,
                    help="one collective's call floor (default: LinkModel's)")
    ap.add_argument("--out", default="", help="also write the rows here as JSON")
    args = ap.parse_args(argv)
    step_ms = {}
    for kv in args.step_ms:
        name, ms = kv.split("=")
        step_ms[name] = float(ms)
    link = LinkModel() if args.latency_ms is None else LinkModel(
        latency_s=args.latency_ms * 1e-3)
    cores = os.cpu_count() or 1
    rows = []
    for spec in args.meshes.split(","):
        shape = tuple(int(x) for x in spec.split("x"))
        n = shape[0] * shape[1]
        if n > cores:
            print(f"mesh {spec}: {n} ranks on {cores} cores, skipped", flush=True)
            continue
        for r in probe(shape, args.batch_per_rank, args.vocab, configs()):
            r.update(project(r, step_ms.get(r["model"]) if not r.get("row_optimizer")
                             else None, link))
            rows.append(r)
            print(json.dumps({k: v for k, v in r.items() if k != "records"}), flush=True)
    print(f"\nlink: {link.gbps_per_direction} GB/s a direction (NVLink 4, data sheet), "
          f"{link.latency_s * 1e3:.4f} ms a collective; per-rank batch "
          f"{args.batch_per_rank}, {args.vocab} ids a field\n")
    print(table(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
