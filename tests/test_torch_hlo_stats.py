"""Collective accounting of the port's sharded step
(``ml_function_tpu_torch/utils/hlo_stats.py``) against the JAX package's
(``tests/test_hlo_stats.py``).

The unit cases hold the wire models and the projection on hand-made
records. The step cases take the JAX test's three cases (the psum step, the
a2a step's id exchange, the sparse-row backward by ``grad_exchange``) at
its shapes: the same ``FeatureSet``, DeepFM ``hidden=(8,)``, B 64 and Adam
on a (4, 2) mesh, the port's on 8 CPU gloo ranks (one spawn for the file,
``torch_parallel_worker.hlo_stats_cases``), the JAX package's compiled on
the 8 virtual devices of ``tests/conftest.py``. Both sides must show the
same kinds and move the same bytes in the id exchanges and the embedding
psum; where eager PyTorch issues apart what XLA merges, the counts differ,
each difference pinned below with its reason.
"""

import ast
import os
import pickle
from collections import Counter
from pathlib import Path

import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

import jax
import ml_function_tpu_torch
import torch_parallel_worker as worker
from ml_function_tpu.features.schema import criteo_feature_set as jfs
from ml_function_tpu.models import get_model as jget_model
from ml_function_tpu.parallel.mesh import make_mesh as jmake_mesh
from ml_function_tpu.parallel.train import create_sharded_state as jcreate_state
from ml_function_tpu.parallel.train import make_sharded_train_step as jmake_step
from ml_function_tpu.parallel.train import shard_batch as jshard_batch
from ml_function_tpu.utils import hlo_stats as jstats
from ml_function_tpu_torch.parallel import comm
from ml_function_tpu_torch.parallel.embedding import INT32_MAX, check_int32_rows
from ml_function_tpu_torch.parallel.launch import spawn
from ml_function_tpu_torch.utils.hlo_stats import (CollectiveInstr, CollectiveStats,
                                                   LinkModel, projected_efficiency,
                                                   record_collectives)

torch.set_num_threads(1)

MESH = (4, 2)                 # (data, model): 8 ranks, conftest's 8 devices
RANKS = MESH[0] * MESH[1]
B = 64
CASES = {"psum": {"exchange": "psum"},
         "a2a": {"exchange": "a2a"},
         "sparse_allgather": {"exchange": "psum", "row_optimizer": "adagrad",
                              "grad_exchange": "allgather"},
         "sparse_a2a": {"exchange": "psum", "row_optimizer": "adagrad",
                        "grad_exchange": "a2a"}}
GROUP = {"data": MESH[0], "model": MESH[1]}
IDS = ("int32", "int64")      # the port's id exchanges, whichever dtype ships
# the sequence-sharded search: ``tests/test_seq_parallel.py``'s planted long
# stream (40 items, L 32, 0 ids are pads), 32 rows, top 6
SEARCH_ITEMS, SEARCH_L, SEARCH_ROWS, SEARCH_K = 40, 32, 32, 6
HLO_DTYPE = {"float32": "f32", "int32": "s32", "int64": "s64", "bool": "pred"}


# ---------------------------------------------------------------------------
# unit cases


@pytest.mark.parametrize("op,k,want", [
    ("all-reduce", 4, 2 * 3 / 4), ("all-gather", 4, 3 / 4), ("reduce-scatter", 4, 3 / 4),
    ("all-to-all", 4, 3 / 4), ("collective-permute", 4, 1.0), ("all-reduce", 2, 1.0),
    ("all-to-all", 8, 7 / 8)])
def test_wire_models(op, k, want):
    """The reference's ring wire models (``test_parse_fake_hlo``'s wire
    assertions): all-reduce 2(K-1)/K·S, all-gather, reduce-scatter and
    all-to-all (K-1)/K·S, collective-permute S."""
    assert CollectiveInstr(op, 128 * 8 * 4, k).wire_bytes() == pytest.approx(
        want * 128 * 8 * 4)


@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter",
                                "all-to-all", "collective-permute"])
def test_a_group_of_one_moves_nothing(op):
    assert CollectiveInstr(op, 4096, 1).wire_bytes() == 0.0


def test_stats_add_up_by_kind():
    s = CollectiveStats([CollectiveInstr("all-reduce", 100, 4, "data", "float32"),
                         CollectiveInstr("all-reduce", 20, 2, "model", "float32"),
                         CollectiveInstr("all-to-all", 64, 2, "model", "int32")])
    assert s.counts == {"all-reduce": 2, "all-to-all": 1}
    assert s.bytes == {"all-reduce": 120, "all-to-all": 64}
    assert (s.total_count, s.total_bytes) == (3, 184)
    assert s.wire_bytes() == pytest.approx(2 * 3 / 4 * 100 + 20 + 32)
    assert s.select(group="model").total_bytes == 84
    assert s.select(op="all-to-all", dtype="int32").counts == {"all-to-all": 1}
    assert s.summary() == {"counts": s.counts, "bytes": s.bytes, "total_count": 3,
                           "total_bytes": 184}


def test_projected_efficiency_with_the_link_model():
    """The counterpart of ``test_projected_efficiency_model`` on the NVLink
    model: 450 GB/s a direction (the data sheet's 900 GB/s over both)."""
    link = LinkModel(latency_s=0.0)
    assert link.bytes_per_s == 450e9 and LinkModel().latency_s == 7.86e-5
    assert LinkModel().comm_s(4.5e9, 10) == pytest.approx(0.010 + 10 * 7.86e-5)
    # 10 ms of compute, 4.5 GB over 450 GB/s = 10 ms of comm: 50% exposed
    p = projected_efficiency(0.010, 4.5e9, 0, link)
    assert p["efficiency"] == pytest.approx(0.5, rel=1e-12)
    assert p["t_comm_s"] == pytest.approx(0.010)
    assert projected_efficiency(0.010, 4.5e9, 0, link, overlap=1.0)["efficiency"] == 1.0
    # half hidden: 5 ms exposed
    assert projected_efficiency(0.010, 4.5e9, 0, link, overlap=0.5)[
        "efficiency"] == pytest.approx(2 / 3)
    # each collective adds the call's latency
    slow = LinkModel(latency_s=1e-3)
    p = projected_efficiency(0.010, 0.0, 10, slow)
    assert p["t_comm_s"] == pytest.approx(0.010) and p["efficiency"] == pytest.approx(0.5)


def test_records_only_inside_the_recorder_and_with_a_group(tmp_path):
    """Outside ``record_collectives`` nothing is recorded; ``group=None``
    issues and records nothing; a group of one is recorded with its size,
    kind and dtype, and moves no wire bytes."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        g = dist.new_group([0])
        comm.name_group(g, "model")
        x = torch.ones(8, dtype=torch.int32)
        with record_collectives() as outer:
            pass
        comm.all_reduce_(x, g)
        assert outer.total_count == 0 and not comm.RECORDERS
        with record_collectives() as s:
            for fn in (comm.all_reduce_, comm.all_min, comm.all_max, comm.all_gather_tensor,
                       comm.all_to_all):
                fn(x.clone(), None)
            comm.ppermute(x.float(), None)
            assert s.total_count == 0
            comm.all_reduce_(x, g)
            comm.all_gather_tensor(x.reshape(2, 4), g)
            with record_collectives() as inner:
                comm.all_to_all(x.long(), dist.new_group([0]))
        assert [(i.op, i.bytes, i.group_size, i.group, i.dtype) for i in s.instrs] == [
            ("all-reduce", 32, 1, "model", "int32"), ("all-gather", 32, 1, "model", "int32"),
            ("all-to-all", 64, 1, "other", "int64")]
        assert inner.instrs == s.instrs[-1:]
        assert s.wire_bytes() == 0.0
    finally:
        dist.destroy_process_group()


def test_the_id_exchanges_refuse_a_table_past_int32():
    """The ids ship as int32, as the reference's; a table whose padded rows
    (the exchanges' sentinel) pass int32 is refused, where the reference's
    ``astype(jnp.int32)`` would wrap (``ROADMAP.md`` Queue 3)."""
    check_int32_rows(INT32_MAX)
    with pytest.raises(ValueError, match="int32"):
        check_int32_rows(INT32_MAX + 1)


COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor", "all_gather_single",
               "all_to_all", "all_to_all_single", "reduce_scatter", "reduce_scatter_tensor",
               "broadcast", "reduce", "gather", "scatter", "send", "recv", "isend", "irecv",
               "batch_isend_irecv", "P2POp", "all_gather_object", "broadcast_object_list",
               "barrier"}


def _dist_calls(tree):
    """The names of ``torch.distributed``'s collectives a module reads."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "torch.distributed"):
            found += [a.name for a in node.names if a.name in COLLECTIVES]
        elif isinstance(node, ast.Attribute) and node.attr in COLLECTIVES:
            v = node.value
            base = (v.id if isinstance(v, ast.Name) else
                    ast.unparse(v) if isinstance(v, ast.Attribute) else "")
            if base in ("dist", "torch.distributed"):
                found.append(node.attr)
    return found


def test_only_comm_calls_the_collectives():
    """No module of the port but ``parallel/comm.py`` calls
    ``torch.distributed``'s collectives, so the recorder sees them all."""
    port = Path(ml_function_tpu_torch.__file__).resolve().parent
    calls = {str(p.relative_to(port)): _dist_calls(ast.parse(p.read_text()))
             for p in port.rglob("*.py")}
    assert calls["parallel/comm.py"], "the source check finds no call at all"
    assert {k: v for k, v in calls.items() if v and k != "parallel/comm.py"} == {}


# ---------------------------------------------------------------------------
# the step cases: the port's 8 ranks against JAX's compiled step


def _jax_step_text(exchange, row_optimizer=None, grad_exchange="a2a"):
    """``tests/test_hlo_stats.py``'s ``_tiny_step``, its compiled HLO."""
    mesh = jmake_mesh(data=MESH[0], model=MESH[1])
    fs = jfs([50] * 4, n_dense=2, embed_dim=4)
    model = jget_model("deepfm", fs, hidden=(8,))
    opt = optax.adam(1e-3)
    batch = {"dense": np.zeros((B, 2), np.float32), "sparse": np.ones((B, 4), np.int32),
             "label": np.zeros((B,), np.float32), "weight": np.ones((B,), np.float32)}
    if row_optimizer:
        from ml_function_tpu.parallel.sparse import (create_sparse_sharded_state,
                                                     make_sparse_sharded_train_step)
        from ml_function_tpu.train.sparse import make_row_optimizer
        ro = make_row_optimizer(row_optimizer)
        ts = create_sparse_sharded_state(model, jax.random.PRNGKey(0), opt, ro, mesh)
        step = make_sparse_sharded_train_step(model, opt, ro, mesh, donate=False,
                                              exchange=exchange,
                                              grad_exchange=grad_exchange)
    else:
        ts = jcreate_state(model, jax.random.PRNGKey(0), opt, mesh)
        step = jmake_step(model, opt, mesh, donate=False, exchange=exchange)
    return jstats.compiled_text(step, ts, jshard_batch(batch, mesh))


def _jax_records(text):
    """(op, bytes, group size, dtypes, element counts) of each collective of
    a compiled module, parsed as the reference parses it, with the dtypes
    and the sizes of the arrays it sends."""
    s = jstats.collective_stats_from_text(text)
    parts = []
    for m in jstats._RE_INSTR.finditer(text):
        if m.group(3) != "-done":
            shapes = jstats._RE_SHAPE.findall(m.group(1))
            sizes = tuple(int(np.prod([int(x) for x in dims.split(",") if x]))
                          for _, dims in shapes)
            parts.append((frozenset(d for d, _ in shapes), sizes,
                          tuple((d, n * jstats._DTYPE_BYTES[d])
                                for (d, _), n in zip(shapes, sizes))))
    assert len(parts) == s.total_count
    return [(i.op, i.bytes, i.group_size) + p for i, p in zip(s.instrs, parts)]


def _search_case():
    """The search's inputs: the table, the long stream's ids and the
    candidates' rows, made from a seed as ``tests/test_seq_parallel.py``'s."""
    rng = np.random.default_rng(0)
    iv = SEARCH_ITEMS + 1
    cand_ids = rng.integers(1, iv, SEARCH_ROWS)
    ids = rng.integers(0, iv, (SEARCH_ROWS, SEARCH_L)).astype(np.int32)
    table = np.random.default_rng(1).normal(size=(iv, 8)).astype(np.float32)
    return {"table": table, "ids": ids, "cand": table[cand_ids], "k": SEARCH_K,
            "data_kw": dict(n_items=SEARCH_ITEMS, L=SEARCH_L)}


def _jax_search_text(case):
    """The JAX package's sequence-sharded search on the (4, 2) mesh, its
    compiled HLO."""
    from ml_function_tpu.features.schema import FeatureSet, SeqSpec, SparseSpec
    from ml_function_tpu.parallel.longseq import seq_sharded_soft_search

    iv = SEARCH_ITEMS + 1
    fs = FeatureSet(sparse=(SparseSpec("item", iv, vocab_name="item", dim=8),),
                    seq=(SeqSpec("hist_item", iv, 8, vocab_name="item", dim=8),
                         SeqSpec("hist_long", iv, SEARCH_L, vocab_name="item", dim=8)))
    mesh = jmake_mesh(data=MESH[0], model=MESH[1])
    fn = jax.jit(lambda t, i, c: seq_sharded_soft_search(mesh, fs, ("hist_long",), case["k"],
                                                         t, {"hist_long": i}, c))
    return jstats.compiled_text(fn, case["table"], case["ids"], case["cand"])


@pytest.fixture(scope="module")
def jax_side():
    out = {name: _jax_records(_jax_step_text(c["exchange"], c.get("row_optimizer"),
                                             c.get("grad_exchange", "a2a")))
           for name, c in CASES.items()}
    out["seq_search"] = _jax_records(_jax_search_text(_search_case()))
    return out


@pytest.fixture(scope="module")
def port_side(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("hlo_stats"))
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump({"mesh": MESH, "cases": {**{k: dict(v, batch=B) for k, v in CASES.items()},
                                             "seq_search": _search_case()}}, f)
    spawn(worker.hlo_stats_cases, RANKS, (io_dir,), store_dir=io_dir)
    out = []
    for r in range(RANKS):
        with open(os.path.join(io_dir, f"results_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _port(port_side, name):
    """Rank 0's records of a case, once every rank's are checked to match
    them and every group's size is its mesh axis's."""
    recs = [r[name]["instrs"] for r in port_side]
    assert all(r == recs[0] for r in recs[1:])
    assert all(GROUP[g] == k for _, _, k, g, _ in recs[0]), recs[0]
    return CollectiveStats([CollectiveInstr(*t) for t in recs[0]])


def _jax_all(jax_side, name, op=None, group=None, ids=None):
    """JAX's records of a case: of one kind, one group (by its size) and,
    with ``ids``, only those that send s32 (True) or none (False)."""
    return [r for r in jax_side[name]
            if (op is None or r[0] == op) and (group is None or r[2] == GROUP[group])
            and (ids is None or ids == (r[3] == {"s32"}))]


def _jax(jax_side, name, op=None, group=None, ids=None):
    """JAX's records of a case: of one kind, one group (by its size) and,
    with ``ids``, only those that send s32 (True) or none (False)."""
    return [r[:2] for r in _jax_all(jax_side, name, op, group, ids)]


def _ids(s, op, group):
    """The port's id exchanges of one kind and group: (bytes, dtype)."""
    return [(i.bytes, i.dtype) for i in s.instrs
            if i.op == op and i.group == group and i.dtype in IDS]


def _same_dense_sums(s, jax_side, name, synced):
    """The data group's all-reduces: the port sums the weight (4 bytes),
    then every synced parameter's gradient in one flat all-reduce, then the
    loss pair (8 bytes). JAX sums the weight alone too, then one tuple of
    the same gradients (the table blocks among them) and the loss terms of
    its partitioned global batch, which XLA's combiner merges into it: a
    scalar and a 4-vector here, where the port's are the weight sum and the
    loss pair. So JAX counts 2 where the port issues 3, and its tuple holds
    every gradient the port's flat all-reduce holds, plus arrays of at most
    4 elements."""
    port = s.select(op="all-reduce", group="data")
    assert [i.bytes for i in port.instrs] == [4, 4 * sum(synced), 8]
    want = _jax_all(jax_side, name, "all-reduce", "data")
    assert len(want) == 2 and want[0][1] == 4
    rest = Counter(want[1][4])
    rest.subtract(Counter(synced))
    assert min(rest.values()) >= 0, "a synced gradient is missing from JAX's tuple"
    assert all(n <= 4 for n in rest.elements()), sorted(rest.elements())


def test_deepfm_psum_step_collective_structure(port_side, jax_side):
    """The psum step stays all-reduce-only, as JAX's: the embedding psum over
    'model' moves JAX's bytes, B_loc·F·(D + 1)·4 (the table's rows and the
    linear weights), in 2 all-reduces where XLA's combiner makes one tuple;
    the data group's sums as ``_same_dense_sums``."""
    s = _port(port_side, "psum")
    assert set(s.counts) == {r[0] for r in jax_side["psum"]} == {"all-reduce"}
    emb = s.select(op="all-reduce", group="model")
    b_loc, f, d = B // MESH[0], 4, 4
    assert [i.bytes for i in emb.instrs] == [b_loc * f * d * 4, b_loc * f * 4]
    assert emb.total_bytes == sum(b for _, b in _jax(jax_side, "psum", "all-reduce", "model"))
    assert len(_jax(jax_side, "psum", "all-reduce", "model")) == 1
    _same_dense_sums(s, jax_side, "psum", port_side[0]["psum"]["synced_numels"])
    assert s.counts == {"all-reduce": 5}


def test_deepfm_a2a_step_has_id_exchange(port_side, jax_side):
    """The a2a step's kinds are JAX's but its reduce-scatters: JAX
    transposes the closing all-gather into a reduce-scatter (psum_scatter)
    over the model group, which sums cotangents that every rank of the group
    holds alike; the port's backward takes its own slice and sums nothing
    (``comm.all_gather_cat``). The id all-to-all ships int32 ids, m·cap·4
    bytes, as JAX's s32 one; the table's and the linear weights' lookups
    each ship them (2), where XLA merges the two identical exchanges (1).
    The rows' all-to-alls (forward and backward, each lookup's) and the
    closing all-gathers move JAX's bytes."""
    s = _port(port_side, "a2a")
    kinds = {r[0] for r in jax_side["a2a"]}
    assert kinds - set(s.counts) == {"reduce-scatter"}
    assert set(s.counts) == {"all-reduce", "all-to-all", "all-gather"}
    m, cap = MESH[1], B // MESH[0] * 4 // MESH[1]
    want = _jax(jax_side, "a2a", "all-to-all", "model", ids=True)
    assert [b for _, b in want] == [m * cap * 4]
    assert _ids(s, "all-to-all", "model") == [(m * cap * 4, "int32")] * 2
    rows = sorted(i.bytes for i in s.instrs if i.op == "all-to-all" and i.dtype == "float32")
    assert rows == sorted(b for _, b in _jax(jax_side, "a2a", "all-to-all", "model", ids=False))
    assert sorted(i.bytes for i in s.select(op="all-gather", group="model").instrs) == sorted(
        b for _, b in _jax(jax_side, "a2a", "all-gather", "model"))
    _same_dense_sums(s, jax_side, "a2a", port_side[0]["a2a"]["synced_numels"])
    assert s.counts.get("all-to-all", 0) >= 2 and s.counts.get("all-reduce", 0) >= 1


def test_sparse_backward_structure_differs_by_grad_exchange(port_side, jax_side):
    """The sparse-row step: the allgather backward gathers only, the a2a
    backward adds the owner-routing all-to-alls, as JAX's. Each id exchange
    ships int32 ids and moves JAX's bytes: the allgather's id all-gather
    over 'data' (N·4), the a2a's id all-to-all over 'model' (m·cap·4) and
    its id all-gather over 'data' (data·m·cap·4). The port routes the
    table's and the linear weights' rows apart (2 of each id exchange),
    where XLA merges their identical id exchanges (1). The forward's psum
    and the data group's sums are the psum step's."""
    ag, a2a = _port(port_side, "sparse_allgather"), _port(port_side, "sparse_a2a")
    for name, s in (("sparse_allgather", ag), ("sparse_a2a", a2a)):
        assert set(s.counts) == {r[0] for r in jax_side[name]}
        emb = s.select(op="all-reduce", group="model").total_bytes
        assert emb == sum(b for _, b in _jax(jax_side, name, "all-reduce", "model"))
        gathers = sorted(i.bytes for i in s.select(op="all-gather", group="data").instrs
                         if i.dtype == "float32")
        assert gathers == sorted(b for _, b in _jax(jax_side, name, "all-gather", "data",
                                                    ids=False))
        # the dense step syncs every parameter but the row tables
        _same_dense_sums(s, jax_side, name, port_side[0][name]["synced_numels"])
    assert ag.counts.get("all-to-all", 0) == 0
    assert a2a.counts.get("all-to-all", 0) >= 2
    assert ag.counts.get("all-gather", 0) >= 2
    n = B // MESH[0] * 4
    m, cap = MESH[1], n // MESH[1]
    want = _jax(jax_side, "sparse_allgather", "all-gather", "data", ids=True)
    assert [b for _, b in want] == [MESH[0] * n * 4]
    assert _ids(ag, "all-gather", "data") == [(MESH[0] * n * 4, "int32")] * 2
    want = _jax(jax_side, "sparse_a2a", "all-to-all", "model", ids=True)
    assert [b for _, b in want] == [m * cap * 4]
    assert _ids(a2a, "all-to-all", "model") == [(m * cap * 4, "int32")] * 2
    want = _jax(jax_side, "sparse_a2a", "all-gather", "data", ids=True)
    assert [b for _, b in want] == [MESH[0] * m * cap * 4]
    assert _ids(a2a, "all-gather", "data") == [(MESH[0] * m * cap * 4, "int32")] * 2


def test_seq_sharded_search_moves_the_references_bytes(port_side, jax_side):
    """The sequence-sharded search's collectives carry JAX's payloads, kind
    by kind and dtype by dtype, all over 'model': the fetch's int32 id
    request and f32 rows back (all-to-all), then the merge's all-gathers of
    the blocks' winners, f32 scores, int32 positions and bool masks (but
    for one all-reduce of JAX's, pinned below). The
    port gathered the positions as int64, twice JAX's bytes, until they
    shipped as int32. Payloads are compared by kind and dtype, not call by
    call, since XLA may fuse the three gathers into one tuple."""
    recs = [r["seq_search"]["instrs"] for r in port_side]
    assert all(r == recs[0] for r in recs[1:])
    assert {(k, g) for _, _, k, g, _ in recs[0]} == {(MESH[1], "model")}
    assert {r[2] for r in jax_side["seq_search"]} == {MESH[1]}
    # JAX's one all-reduce sums an f32 (1, D) row over 'model' that the
    # fetch's row gather (``_take``) reads: XLA's partitioner adds it to the
    # compiled module; the port's fetch issues no such sum
    extra = [r for r in jax_side["seq_search"] if r[0] == "all-reduce"]
    assert [r[5] for r in extra] == [(("f32", 4 * 8),)]
    port, want = Counter(), Counter()
    for op, nbytes, _, _, dtype in recs[0]:
        port[op, HLO_DTYPE[dtype]] += nbytes
    for r in jax_side["seq_search"]:
        for dtype, nbytes in r[5] if r[0] != "all-reduce" else ():
            want[r[0], dtype] += nbytes
    assert port == want
    n = SEARCH_ROWS // MESH[0] * MESH[1] * min(SEARCH_K, SEARCH_L // MESH[1])
    assert {k: v for k, v in port.items() if k[0] == "all-gather"} == {
        ("all-gather", "f32"): 4 * n, ("all-gather", "s32"): 4 * n,
        ("all-gather", "pred"): n}
