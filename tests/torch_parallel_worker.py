"""The ranks' side of the sharded-path tests (``tests/test_torch_parallel*.py``,
``test_torch_cli.py``, ``test_torch_checkpoint.py``,
``test_torch_multihost.py``).

A test file spawns its ranks once (``ml_function_tpu_torch.parallel.launch
.spawn``, gloo on the CPU); each rank runs every case of the file from the
inputs the test wrote (``inputs.pkl``: the JAX package's parameters and the
case settings) and writes its results (``results_<rank>.pkl``). A spawned
rank re-imports this module, so it imports the port and nothing of JAX.
"""

import os
import pickle

import numpy as np
import torch

from ml_function_tpu_torch.bridge import sharded_params_to_numpy, state_buffers
from ml_function_tpu_torch.features import synthetic
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.models.base import embed_inputs, stateless
from ml_function_tpu_torch.ops.base import init_parameters
from ml_function_tpu_torch.ops.core import MLP
from ml_function_tpu_torch.ops.embedding import FusedEmbedding
from ml_function_tpu_torch.parallel import comm
from ml_function_tpu_torch.parallel.embedding import (ShardedLookup, pad_table_for_shards,
                                                      rows_per_shard)
from ml_function_tpu_torch.parallel.mesh import make_mesh
from ml_function_tpu_torch.parallel.train import (create_sharded_state, evaluate_sharded,
                                                  make_sharded_train_step, shard_batch)
from ml_function_tpu_torch.train.loop import iter_batches
from ml_function_tpu_torch.train.optimizers import make_optimizer


def load_inputs(io_dir):
    with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
        return pickle.load(f)


def save_results(io_dir, rank, results):
    with open(os.path.join(io_dir, f"results_{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def make_data(kind, kw):
    return getattr(synthetic, kind)(**kw)


def bn_model(fs, seed=0):
    """Embedding → MLP(norm='batch') → logit: a model with running state
    (no registry model has one)."""
    din = len(fs.sparse) * fs.embed_dim + len(fs.dense)
    parts = {"embedding": FusedEmbedding(fs),
             "mlp": MLP(din, (8,), norm="batch", out_dim=1)}

    def fwd(m, batch, train):
        x = embed_inputs(m.embedding, batch, with_linear=False)
        h = torch.cat([x["emb"].flatten(1), x["dense"]], dim=-1)
        return m.mlp(h, train)[:, 0], {"emb_l2": x["l2"]}

    return init_parameters(stateless("bn_mlp", fs, parts, fwd),
                           torch.Generator().manual_seed(seed))


def sim_feature_set(n_items: int, L: int):
    """SIM's schema of the sequence-sharded cases: a candidate item, a short
    history of 8 and a long stream of L, one vocab, width 8."""
    from ml_function_tpu_torch.features.schema import FeatureSet, SeqSpec, SparseSpec
    iv = n_items + 1
    return FeatureSet(
        sparse=(SparseSpec("item", iv, vocab_name="item", dim=8),),
        seq=(SeqSpec("hist_item", iv, 8, vocab_name="item", dim=8),
             SeqSpec("hist_long", iv, L, vocab_name="item", dim=8)))


def build(case):
    """(fs, data, model) of a step case; the model bridged from the case's
    parameters when it carries them."""
    if case["data"] == "sim_feature_set":
        fs, data = sim_feature_set(**case["data_kw"]), None
        return fs, data, get_model(case["model"], fs, device="cpu", **case.get("hp", {}))
    fs, data = make_data(case["data"], case["data_kw"])
    if case["model"] == "bn_mlp":
        model = bn_model(fs)
    else:
        model = get_model(case["model"], fs, device="cpu", **case.get("hp", {}))
    return fs, data, model


def optimizer(case):
    name, lr = case["opt"]
    return make_optimizer(name, lr)


def full_state(model):
    return {k: v.detach().cpu().numpy().copy() for k, v in state_buffers(model).items()}


# ---------------------------------------------------------------------------
# test_torch_parallel.py


def lookup_case(case, mesh):
    """Rows (the global batch's) and the table gradient of sum(sin(rows))
    (the whole padded table's) of one collective lookup, and its overflow
    count."""
    table, gids = torch.tensor(case["table"]), torch.tensor(case["gids"])
    m, d = mesh.model, mesh.data
    r = rows_per_shard(table.shape[0], m)
    block = pad_table_for_shards(table, m)[mesh.model_index * r:(mesh.model_index + 1) * r]
    block = block.clone().requires_grad_()
    b = gids.shape[0] // d
    mine = gids[mesh.data_index * b:(mesh.data_index + 1) * b]
    sl = ShardedLookup(mesh, None, mode=case["mode"], capacity=case["capacity"],
                       compress=case["compress"])
    rows = sl.lookup(block, mine)
    rows.sin().sum().backward()
    grad = comm.all_reduce_(block.grad.clone(), mesh.data_group)
    return {"rows": comm.all_gather_tensor(rows.detach(), mesh.data_group).numpy(),
            "grad": comm.all_gather_tensor(grad, mesh.model_group).numpy(),
            "overflow": sl.overflow_count(mine, rows=table.shape[0])}


def step_case(case, mesh):
    """One sharded step (or ``case['steps']``) from the bridged parameters:
    the losses, the parameters after it (gathered, unpadded), the running
    state and the a2a overflow counts."""
    fs, data, model = build(case)
    ts = create_sharded_state(model, optimizer(case), mesh, init_params=case.get("params"))
    step = make_sharded_train_step(ts.model, ts.optimizer, mesh,
                                   exchange=case.get("exchange", "psum"),
                                   compress=case.get("compress"),
                                   capacity=case.get("capacity"))
    batches = list(iter_batches(data, case["batch"]))
    batches = [batches[i] for i in case["which"]]
    losses, overflow = [], []
    for b in batches:
        out = step(shard_batch(b, mesh))
        losses.append(float(out["loss"]))
        overflow.append(out.get("a2a_overflow"))
    return {"losses": losses, "overflow": overflow,
            "params": sharded_params_to_numpy(ts.model, ts.layout, mesh),
            "state": full_state(ts.model), "layout": dict(ts.layout),
            "block_shapes": {n: tuple(p.shape) for n, p in ts.model.named_parameters()}}


def run_case(case, mesh):
    """``case['steps']`` shuffled steps, then the streaming eval over the
    data (merged over the data group)."""
    fs, data, model = build(case)
    ts = create_sharded_state(model, optimizer(case), mesh, init_params=case["params"])
    step = make_sharded_train_step(ts.model, ts.optimizer, mesh)
    n = 0
    for epoch in range(case["epochs"]):
        for b in iter_batches(data, case["batch"], shuffle=True, seed=epoch):
            if n == case["steps"]:
                break
            step(shard_batch(b, mesh))
            n += 1
    return {"steps": n, "eval": evaluate_sharded(ts.model, mesh, data, case["batch"])}


def scorer_case(case, mesh):
    from ml_function_tpu_torch.bridge import params_from_numpy
    from ml_function_tpu_torch.serving import ShardedScorer
    fs, data, model = build(case)
    params_from_numpy(model, case["params"])
    scorer = ShardedScorer(model, mesh, batch_size=case["batch"])
    n = case["n_rows"]
    rows = {k: ({s: a[:n] for s, a in v.items()} if isinstance(v, dict) else v[:n])
            for k, v in data.items() if k != "label"}
    return {"probs": scorer.predict_proba(rows),
            "block_rows": scorer.model.embedding.table.shape[0]}


def parallel_cases(rank, io_dir):
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    inputs = load_inputs(io_dir)
    meshes = {(2, 2): make_mesh(2, 2, device="cpu"), (1, 4): make_mesh(1, 4, device="cpu")}
    out = {"coords": meshes[(2, 2)].coords}
    for kind, fn in (("lookups", lookup_case), ("steps", step_case),
                     ("runs", run_case), ("scorers", scorer_case)):
        out[kind] = {name: fn(case, meshes[case["mesh"]])
                     for name, case in inputs[kind].items()}
    save_results(io_dir, rank, out)


# ---------------------------------------------------------------------------
# test_torch_parallel_sparse.py


def row_optimizer(spec):
    from ml_function_tpu_torch.train.sparse import make_row_optimizer
    name, lr = spec
    return make_row_optimizer(name, lr)


def sparse_case(case, mesh):
    """``case['steps']`` sparse-row steps on row-sharded tables: the losses,
    every parameter after them (gathered, unpadded), the row states' block
    shapes and the gradient overflow counts."""
    from ml_function_tpu_torch.parallel.sparse import (create_sparse_sharded_state,
                                                       make_sparse_sharded_train_step)
    fs, data, model = build(case)
    ts = create_sparse_sharded_state(model, optimizer(case), row_optimizer(case["rows"]),
                                     mesh, init_params=case.get("params"))
    step = make_sparse_sharded_train_step(
        ts, compress=case.get("compress"), grad_exchange=case["grad_exchange"],
        grad_capacity=case.get("grad_capacity"))
    losses, overflow = [], []
    for b in list(iter_batches(data, case["batch"]))[:case["steps"]]:
        out = step(shard_batch(b, mesh))
        losses.append(float(out["loss"]))
        overflow.append(out.get("grad_a2a_overflow"))
    return {"losses": losses, "overflow": overflow,
            "params": sharded_params_to_numpy(ts.model, ts.layout, mesh),
            "row_shapes": {g: {k: tuple(v.shape) for k, v in st.items()}
                           for g, st in ts.rows.items()},
            "layout": dict(ts.layout)}


def sparse_cases(rank, io_dir):
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    inputs = load_inputs(io_dir)
    meshes = {(2, 2): make_mesh(2, 2, device="cpu"), (1, 4): make_mesh(1, 4, device="cpu")}
    save_results(io_dir, rank, {name: sparse_case(case, meshes[case["mesh"]])
                                for name, case in inputs.items()})


# ---------------------------------------------------------------------------
# test_torch_multihost.py


def multihost_cases(rank, io_dir):
    """``host_batch_slice`` and ``global_metrics`` by the data coordinate
    on a (2, 2) mesh, and each rank's heartbeat file."""
    from ml_function_tpu_torch.parallel.multihost import (Heartbeat, global_metrics,
                                                          host_batch_slice, init_multihost)
    from ml_function_tpu_torch.train.metrics import init_metrics, update_metrics
    inputs = load_inputs(io_dir)
    mesh = make_mesh(2, 2, device="cpu")
    start, per = host_batch_slice(len(inputs["labels"]), mesh)
    logits = torch.tensor(inputs["logits"][start:start + per])
    labels = torch.tensor(inputs["labels"][start:start + per])
    merged = global_metrics(update_metrics(init_metrics(), logits, labels), mesh)
    hb = Heartbeat(os.path.join(io_dir, "hb"), interval_s=0.0, timeout_s=600.0)
    hb.beat(step=rank)
    comm.barrier()
    save_results(io_dir, rank, {
        "init": init_multihost(), "coords": mesh.coords, "slice": (start, per),
        "metrics": {k: v.numpy() for k, v in merged.items()},
        "stale": hb.stale_hosts(), "beat": os.path.exists(hb.path(rank))})


# ---------------------------------------------------------------------------
# test_torch_checkpoint.py


def _snapshot(ts):
    from ml_function_tpu_torch.train.checkpoint import state_arrays
    return {k: np.array(v, copy=True) for k, v in state_arrays(ts).items()}


def checkpoint_cases(rank, io_dir):
    """On a (2, 2) mesh: two sharded Adam steps from the bridged parameters,
    a sharded checkpoint, its restore on the same grid into a fresh state
    (each rank's arrays, and the next step's loss), a sparse-row state's
    round trip, and the fallback past a torn shard file."""
    from ml_function_tpu_torch.parallel.sparse import create_sparse_sharded_state
    from ml_function_tpu_torch.train import checkpoint as ckpt
    inputs = load_inputs(io_dir)
    case = inputs["dense"]
    mesh = make_mesh(2, 2, device="cpu")

    def fresh(seed):
        fs, data, model = build(case)
        init = case["params"] if seed == 0 else None
        if seed:
            model = get_model(case["model"], fs, device="cpu",
                              generator=torch.Generator().manual_seed(seed),
                              **case.get("hp", {}))
        ts = create_sharded_state(model, optimizer(case), mesh, init_params=init)
        return data, ts, make_sharded_train_step(ts.model, ts.optimizer, mesh)

    data, ts, step = fresh(0)
    batches = [shard_batch(b, mesh) for b in iter_batches(data, case["batch"])]
    for b in batches[:2]:
        step(b)
    ts.step = 2
    ck_dir = os.path.join(io_dir, "ck22")
    ckpt.save_checkpoint(ck_dir, ts)
    saved = _snapshot(ts)
    full = sharded_params_to_numpy(ts.model, ts.layout, mesh)
    _, ts2, step2 = fresh(1)
    ts2, _, path = ckpt.restore_latest(ck_dir, ts2)
    restored = _snapshot(ts2)
    next_losses = [float(step(batches[2])["loss"]), float(step2(batches[2])["loss"])]

    # a sparse-row state through the sharded format
    fs, _, model = build(case)
    sp = create_sparse_sharded_state(model, optimizer(case), row_optimizer(("adagrad", 0.05)),
                                     mesh, init_params=case["params"])
    for st in sp.rows.values():
        for v in st.values():
            if v.is_floating_point():
                v.add_(mesh.model_index + 1)      # blocks that differ by owner
    sp.step = 5
    sp_dir = os.path.join(io_dir, "sparse")
    ckpt.save_checkpoint(sp_dir, sp)
    sp_saved = _snapshot(sp)
    fs, _, model2 = build(case)
    sp2 = create_sparse_sharded_state(model2, optimizer(case),
                                      row_optimizer(("adagrad", 0.05)), mesh)
    sp2, _, _ = ckpt.restore_latest(sp_dir, sp2)
    sp_restored = _snapshot(sp2)

    # a torn shard file in the newest checkpoint: every rank falls back
    ts.step = 3
    torn = ckpt.save_checkpoint(ck_dir, ts)
    if rank == 0:
        shard = os.path.join(torn, "shards_00001.npz")
        with open(shard, "r+b") as f:
            f.truncate(os.path.getsize(shard) // 2)
    comm.barrier()
    _, ts3, _ = fresh(2)
    ts3, _, path3 = ckpt.restore_latest(ck_dir, ts3)
    comm.barrier()
    save_results(io_dir, rank, {
        "path": path, "saved": saved, "restored": restored, "full": full,
        "step": ts2.step, "next_losses": next_losses, "layout": dict(ts.layout),
        "sp_saved": sp_saved, "sp_restored": sp_restored, "sp_step": sp2.step,
        "fallback": (os.path.basename(path3), ts3.step, _snapshot(ts3)),
        "files": sorted(os.listdir(path)), "dir": sorted(os.listdir(ck_dir))})


# ---------------------------------------------------------------------------
# test_torch_cli.py


def cli_cases(rank, io_dir):
    """The CLI on two ranks: each run of ``inputs['runs']`` (name, argv and
    the JAX CLI's initial ``(params, model_state)`` or None), in order, its
    state built from those parameters; the results by name."""
    from ml_function_tpu_torch.parallel import sparse
    from ml_function_tpu_torch.train import cli
    real = cli.create_sharded_state, sparse.create_sparse_sharded_state
    out = {}
    for name, argv, init in load_inputs(io_dir)["runs"]:
        if init is not None:
            cli.create_sharded_state = (lambda model, opt, mesh, seed=0: real[0](
                model, opt, mesh, init_params=init, seed=seed))
            sparse.create_sparse_sharded_state = (lambda model, opt, row_opt, mesh: real[1](
                model, opt, row_opt, mesh, init_params=init))
        try:
            out[name] = cli.main(argv)
        finally:
            cli.create_sharded_state, sparse.create_sparse_sharded_state = real
    save_results(io_dir, rank, out)


# ---------------------------------------------------------------------------
# test_torch_seq_parallel.py


def attention_case(case, mesh):
    """Ring or dist attention over the model group: the output and the
    gradients of sum(sin(out)) (dk and dv summed over the group, each rank
    holding its block's)."""
    from ml_function_tpu_torch.parallel.seq_parallel import make_seq_parallel_attention
    q, k, v = (torch.tensor(case[n]).requires_grad_() for n in ("q", "k", "v"))
    out = make_seq_parallel_attention(mesh, mode=case["mode"])(q, k, v,
                                                               torch.tensor(case["mask"]))
    out.sin().sum().backward()
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(),
            "dk": comm.all_reduce_(k.grad.clone(), mesh.model_group).numpy(),
            "dv": comm.all_reduce_(v.grad.clone(), mesh.model_group).numpy()}


def search_inputs(case, mesh):
    """A search case's feature set, and this rank's table block, long
    stream rows and candidate rows."""
    fs = sim_feature_set(**case["data_kw"])
    table = torch.tensor(case["table"])
    b = len(case["ids"]) // mesh.data
    rows = slice(mesh.data_index * b, (mesh.data_index + 1) * b)
    r = rows_per_shard(table.shape[0], mesh.model)
    block = pad_table_for_shards(table, mesh.model)[mesh.model_index * r:
                                                    (mesh.model_index + 1) * r]
    return fs, block, torch.tensor(case["ids"][rows]), torch.tensor(case["cand"][rows])


def search_case(case, mesh):
    """The sequence-sharded soft search on this rank's rows, and the
    unsharded soft search's choice (the whole table, ``top_k_indices``) on
    the same rows."""
    from ml_function_tpu_torch.models.longseq import top_k_indices
    from ml_function_tpu_torch.parallel.longseq import seq_sharded_soft_search
    fs, block, ids, cand = search_inputs(case, mesh)
    table = torch.tensor(case["table"])
    top, red = seq_sharded_soft_search(mesh, fs, ("hist_long",), case["k"], block,
                                       {"hist_long": ids}, cand,
                                       capacity=case.get("capacity"))
    mask = ids != 0
    gids = ids.long() + fs.seq_offset("hist_long")
    full = table[gids] * mask[..., None]
    scores = torch.where(mask, torch.einsum("bld,bd->bl", full, cand), -torch.inf)
    want = top_k_indices(scores, case["k"])
    return {"top": comm.all_gather_tensor(top, mesh.data_group).numpy(),
            "red": comm.all_gather_tensor(red, mesh.data_group).numpy(),
            "unsharded": comm.all_gather_tensor(want, mesh.data_group).numpy(),
            "unsharded_mask": comm.all_gather_tensor(torch.gather(mask, 1, want),
                                                     mesh.data_group).numpy()}


def flagged_step_case(case, mesh):
    """One sharded step with the case's flags from the bridged parameters:
    the loss, this data row's logits (gathered over the data group) and
    every parameter after it."""
    fs, data, model = build(case)
    ts = create_sharded_state(model, optimizer(case), mesh, init_params=case["params"])
    step = make_sharded_train_step(ts.model, ts.optimizer, mesh,
                                   seq_shard=case.get("seq_shard", False),
                                   pp_microbatches=case.get("pp_microbatches", 0))
    out = step(shard_batch(case["batch"], mesh))
    return {"loss": float(out["loss"]),
            "logits": comm.all_gather_tensor(out["logits"], mesh.data_group).numpy(),
            "params": sharded_params_to_numpy(ts.model, ts.layout, mesh)}


def seq_parallel_cases(rank, io_dir):
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    inputs = load_inputs(io_dir)
    meshes = {(2, 2): make_mesh(2, 2, device="cpu"), (1, 4): make_mesh(1, 4, device="cpu")}
    out = {}
    for kind, fn in (("attention", attention_case), ("search", search_case),
                     ("steps", flagged_step_case)):
        out[kind] = {name: fn(case, meshes[case["mesh"]])
                     for name, case in inputs[kind].items()}
    save_results(io_dir, rank, out)


# ---------------------------------------------------------------------------
# test_torch_gpipe.py


def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def pipeline_case(case, mesh):
    """``make_pipeline`` on this rank's rows: the output (gathered over the
    data group) and the gradient of mean(y²) over the global batch for each
    stacked leaf."""
    from ml_function_tpu_torch.parallel.pipeline import make_pipeline
    params = {k: torch.tensor(v).requires_grad_() for k, v in case["params"].items()}
    x = torch.tensor(case["x"])
    b = x.shape[0] // mesh.data
    mine = x[mesh.data_index * b:(mesh.data_index + 1) * b]
    y = make_pipeline(mesh, _stage_fn, case["m"])(params, mine)
    (y.square().sum() / y.numel() / mesh.data).backward()
    return {"y": comm.all_gather_tensor(y.detach(), mesh.data_group).numpy(),
            "grads": {k: comm.all_reduce_(p.grad.clone(), mesh.data_group).numpy()
                      for k, p in params.items()}}


def gpipe_cases(rank, io_dir):
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    inputs = load_inputs(io_dir)
    meshes = {(2, 2): make_mesh(2, 2, device="cpu"), (1, 4): make_mesh(1, 4, device="cpu")}
    out = {}
    for kind, fn in (("pipelines", pipeline_case), ("steps", flagged_step_case)):
        out[kind] = {name: fn(case, meshes[case["mesh"]])
                     for name, case in inputs[kind].items()}
    save_results(io_dir, rank, out)


def recorded_step(case, mesh):
    """One DeepFM step of ``case`` (the exchange, the row optimizer and its
    gradient exchange) on this rank under the collective recorder
    (``tools/scaling_report.record_step`` at ``tests/test_hlo_stats.py``'s
    shapes): its records as (op, bytes, group size, group kind, dtype)
    tuples, and the sizes of the parameters whose gradients the step sums
    over the data group."""
    from ml_function_tpu_torch.features.schema import criteo_feature_set
    from ml_function_tpu_torch.tools.scaling_report import record_step

    fs = criteo_feature_set([50] * 4, n_dense=2, embed_dim=4)
    row = record_step({"model": "deepfm", **case}, mesh, case["batch"] // mesh.data, fs,
                      {"hidden": (8,)})
    return {"instrs": [tuple(r) for r in row["records"]],
            "synced_numels": row["synced_numels"]}


def recorded_search(case, mesh):
    """The sequence-sharded soft search of ``search_case`` under the
    collective recorder: its records as ``recorded_step``'s."""
    from ml_function_tpu_torch.parallel.longseq import seq_sharded_soft_search
    from ml_function_tpu_torch.utils.hlo_stats import collective_stats

    fs, block, ids, cand = search_inputs(case, mesh)
    stats = collective_stats(seq_sharded_soft_search, mesh, fs, ("hist_long",), case["k"],
                             block, {"hist_long": ids}, cand)
    return {"instrs": [(i.op, i.bytes, i.group_size, i.group, i.dtype)
                       for i in stats.instrs]}


def hlo_stats_cases(rank, io_dir):
    inputs = load_inputs(io_dir)
    mesh = make_mesh(*inputs["mesh"], device="cpu")
    save_results(io_dir, rank, {name: (recorded_search if name == "seq_search" else
                                       recorded_step)(case, mesh)
                                for name, case in inputs["cases"].items()})
