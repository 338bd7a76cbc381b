"""The sequence-parallel paths of the port (``parallel/seq_parallel.py``,
``parallel/longseq.py`` and SIM's sequence-sharded route) on gloo ranks,
against the JAX package on a mesh of the same shape.

The port runs in 4 spawned processes (one spawn for the file,
``torch_parallel_worker.seq_parallel_cases``) on (1, 4) and (2, 2) meshes;
the JAX side runs here on 4 of the 8 virtual CPU devices, with
``ML_FUNCTION_TPU_F32_MATMUL=1`` on both.

Bars, each beside its reason:
- ring and dist attention: the output and dq, dk, dv within 1e-5 of the
  JAX package's (the JAX tests' bar against dense attention; both sides sum
  the blocks' partials in another order than a dense softmax does);
- the sequence-sharded search: positions and masks bit for bit, against
  the JAX package's and against the port's unsharded soft search (the same
  per-row dot products, and a merge by (−score, position), which is
  ``lax.top_k``'s choice and order);
- one ``seq_shard=True`` SIM step: the loss within rtol 1e-6, the logits
  1e-5 and the table 1e-5 of the JAX package's ``seq_shard=True`` step, the
  bars of the JAX test that holds that step against the unsharded one.
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
from ml_function_tpu.features.schema import FeatureSet as JFeatureSet
from ml_function_tpu.features.schema import SeqSpec as JSeqSpec
from ml_function_tpu.features.schema import SparseSpec as JSparseSpec
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.parallel.longseq import seq_shard_wire_bytes as jax_wire_bytes
from ml_function_tpu.parallel.longseq import seq_sharded_soft_search as jax_search
from ml_function_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ml_function_tpu.parallel.seq_parallel import make_seq_parallel_attention as jax_attn
from ml_function_tpu.parallel.train import create_sharded_state as jax_sharded_state
from ml_function_tpu.parallel.train import make_sharded_train_step as jax_sharded_step
from ml_function_tpu.parallel.train import shard_batch as jax_shard_batch
from ml_function_tpu_torch.parallel import context as pctx
from ml_function_tpu_torch.parallel.launch import spawn
from ml_function_tpu_torch.parallel.longseq import (seq_shard_wire_bytes,
                                                    seq_sharded_soft_search)
from ml_function_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
N_ITEMS, L, TOP_K = 40, 32, 6


@pytest.fixture(scope="module", autouse=True)
def _f32():
    old = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    yield
    if old is None:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    else:
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = old


def _qkvm():
    """The JAX test's inputs: (B, H, Lq, Lk, Dh) = (2, 2, 4, 64, 8), 30 %
    of the keys masked, and a mask that leaves only the first 8 keys (three
    of the four blocks wholly masked)."""
    rng = np.random.default_rng(0)
    b, h, lq, lk, dh = 2, 2, 4, 64, 8
    q = rng.normal(size=(b, h, lq, dh)).astype(np.float32)
    k = rng.normal(size=(b, h, lk, dh)).astype(np.float32)
    v = rng.normal(size=(b, h, lk, dh)).astype(np.float32)
    mask = rng.uniform(size=(b, lk)) > 0.3
    mask[:, 0] = True
    first8 = np.zeros((b, lk), bool)
    first8[:, :8] = True
    return q, k, v, {"mask": mask, "fully_masked_shard": first8}


def _sim_case(seed=0, n_rows=32):
    """The JAX test's planted long-stream batch (0 ids are pads) and SIM
    over it."""
    rng = np.random.default_rng(seed)
    iv = N_ITEMS + 1
    cand = rng.integers(1, iv, n_rows).astype(np.int32)
    hist_long = rng.integers(0, iv, (n_rows, L)).astype(np.int32)
    hist_short = rng.integers(1, iv, (n_rows, 8)).astype(np.int32)
    fs = JFeatureSet(
        sparse=(JSparseSpec("item", iv, vocab_name="item", dim=8),),
        seq=(JSeqSpec("hist_item", iv, 8, vocab_name="item", dim=8),
             JSeqSpec("hist_long", iv, L, vocab_name="item", dim=8)))
    batch = {"dense": np.zeros((n_rows, 0), np.float32), "sparse": cand[:, None],
             "seq": {"hist_item": hist_short, "hist_long": hist_long},
             "label": (rng.random(n_rows) < 0.5).astype(np.float32)}
    return fs, batch


SIM_HP = dict(hidden=(16, 8), search="soft", top_k=TOP_K, candidate=("item",),
              behavior=("hist_item",), long_behavior=("hist_long",))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("seq_parallel"))
    devs = jax.devices()[:4]
    mesh14 = jax_make_mesh(data=1, model=4, devices=devs)
    mesh22 = jax_make_mesh(data=2, model=2, devices=devs)
    want = {"attention": {}, "search": {}, "steps": {}}
    inputs = {"attention": {}, "search": {}, "steps": {}}

    q, k, v, masks = _qkvm()
    for mode in ("dist", "ring"):
        attn = jax_attn(mesh14, "model", mode=mode)
        for mname, mask in masks.items():
            args = tuple(jnp.asarray(a) for a in (q, k, v))
            jm = jnp.asarray(mask)
            out = jax.jit(lambda a, b, c: attn(a, b, c, jm))(*args)
            grads = jax.jit(jax.grad(lambda a, b, c: jnp.sum(jnp.sin(attn(a, b, c, jm))),
                                     argnums=(0, 1, 2)))(*args)
            name = f"{mode}_{mname}"
            want["attention"][name] = {"out": np.asarray(out),
                                       **{f"d{n}": np.asarray(g)
                                          for n, g in zip("qkv", grads)}}
            inputs["attention"][name] = {"q": q, "k": k, "v": v, "mask": mask,
                                         "mode": mode, "mesh": (1, 4)}

    fs, batch = _sim_case()
    rng = np.random.default_rng(1)
    table = rng.normal(size=(fs.total_vocab, 8)).astype(np.float32)
    cand = table[batch["sparse"][:, 0] + fs.vocab_offsets["item"]]
    ids = batch["seq"]["hist_long"]
    for name, mesh, cap in (("search_22", mesh22, None), ("search_22_capacity32", mesh22, 32),
                            ("search_14", mesh14, None)):
        top, red = jax.jit(lambda t, i, c: jax_search(
            mesh, fs, ("hist_long",), TOP_K, t, {"hist_long": i}, c, capacity=cap))(
                jnp.asarray(table), jnp.asarray(ids), jnp.asarray(cand))
        want["search"][name] = {"top": np.asarray(top), "red": np.asarray(red)}
        inputs["search"][name] = {"table": table, "ids": ids, "cand": cand, "k": TOP_K,
                                  "capacity": cap, "data_kw": dict(n_items=N_ITEMS, L=L),
                                  "mesh": tuple(mesh.shape.values())}

    model = jax_get_model("sim", fs, **SIM_HP)
    opt = optax.adam(1e-2)
    sts = jax_sharded_state(model, jax.random.PRNGKey(0), opt, mesh22)
    params = jax.tree_util.tree_map(np.asarray, sts.params)
    step = jax_sharded_step(model, opt, mesh22, donate=False, seq_shard=True)
    sts2, out = step(sts, jax_shard_batch(batch, mesh22))
    want["steps"]["sim_seq_shard"] = {
        "loss": float(out["loss"]), "logits": np.asarray(out["logits"]),
        "table": np.asarray(sts2.params["dien"]["embedding"]["table"])}
    for name, flag in (("sim_seq_shard", True), ("sim_unflagged", False)):
        inputs["steps"][name] = {"model": "sim", "data": "sim_feature_set",
                                 "data_kw": dict(n_items=N_ITEMS, L=L), "hp": SIM_HP,
                                 "opt": ("adam", 1e-2), "params": params, "batch": batch,
                                 "seq_shard": flag, "mesh": (2, 2)}

    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    spawn(worker.seq_parallel_cases, 4, (io_dir,), store_dir=io_dir)
    port = {}
    for r in range(4):
        with open(os.path.join(io_dir, f"results_{r}.pkl"), "rb") as f:
            port[r] = pickle.load(f)
    return want, port


@pytest.mark.parametrize("name", ["dist_mask", "ring_mask", "dist_fully_masked_shard",
                                  "ring_fully_masked_shard"])
def test_seq_parallel_attention_matches_jax(runs, name):
    """Ring and dist attention over keys split in four blocks: the output
    and the gradients of sum(sin(out)) against the JAX package's, also with
    three blocks wholly masked (finite, no NaN); every rank holds the same
    output."""
    want, port = runs
    got = port[0]["attention"][name]
    assert np.isfinite(got["out"]).all()
    for key in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(got[key], want["attention"][name][key], err_msg=key,
                                   **ATTN_TOL)
    for r in range(1, 4):
        np.testing.assert_allclose(port[r]["attention"][name]["out"], got["out"], **ATTN_TOL)


@pytest.mark.parametrize("name", ["search_22", "search_22_capacity32", "search_14"])
def test_seq_sharded_search_matches_jax_and_unsharded(runs, name):
    """The search with the stream's 32 columns split over the model group
    (blocks of 16 or 8; a capacity of 32 clamped to the 21 rows of a table
    block)
    selects the JAX package's positions and masks, and the port's
    unsharded soft search's, bit for bit, on every rank."""
    want, port = runs
    for r in range(4):
        got = port[r]["search"][name]
        np.testing.assert_array_equal(got["top"], want["search"][name]["top"])
        np.testing.assert_array_equal(got["red"], want["search"][name]["red"])
        np.testing.assert_array_equal(got["top"], got["unsharded"])
        np.testing.assert_array_equal(got["red"], got["unsharded_mask"])


def test_seq_shard_sim_step_matches_jax(runs):
    """One SIM Adam step with ``seq_shard=True`` on a (2, 2) mesh from the
    JAX state's parameters: the loss, the logits and the table after it
    against the JAX package's ``seq_shard=True`` step; and the same step
    without the flag within the same bars of it (the flag changes the
    route, not the result)."""
    want, port = runs
    w = want["steps"]["sim_seq_shard"]
    for name in ("sim_seq_shard", "sim_unflagged"):
        got = port[0]["steps"][name]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["logits"], w["logits"], rtol=1e-5, atol=1e-5)
        t = got["params"]["dien"]["embedding"]["table"]
        np.testing.assert_allclose(t, w["table"][:t.shape[0]], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("args", [(64, 16384, 8, 16, 128), (32, 1024, 2, 8, 32, 2),
                                  (512, 16384, 1, 16, 256), (8, 96, 4, 64, 300, 3, 2)])
def test_seq_shard_wire_bytes_match_reference(args):
    assert seq_shard_wire_bytes(*args) == jax_wire_bytes(*args)


def test_seq_sharded_search_refusals():
    """An L that the model group does not divide, and long fields of
    unequal lengths, raise the reference's ValueErrors before any
    collective."""
    fs = worker.sim_feature_set(N_ITEMS, L)
    mesh = Mesh(1, 3, (0, 0), (0, 1, 2), None, None, torch.device("cpu"))
    ids = {"hist_long": torch.zeros((2, L), dtype=torch.long)}
    with pytest.raises(ValueError, match="must divide the model axis 3"):
        seq_sharded_soft_search(mesh, fs, ("hist_long",), 4, torch.zeros((14, 8)), ids,
                                torch.zeros((2, 8)))
    with pytest.raises(ValueError, match="equal max_len"):
        seq_sharded_soft_search(mesh, fs, ("hist_long", "hist_item"), 4,
                                torch.zeros((14, 8)), ids, torch.zeros((2, 8)))


def test_context_sets_and_restores_the_flags():
    mesh = Mesh(1, 2, (0, 0), (0, 1), None, None, torch.device("cpu"))
    with pctx.sharded_embeddings(mesh, mode="a2a", seq_shard=True, pp_microbatches=4):
        assert pctx.seq_shard_active() and pctx.pp_microbatches() == 4
        with pctx.sharded_embeddings(mesh):
            assert not pctx.seq_shard_active() and pctx.pp_microbatches() == 0
        assert pctx.seq_shard_active() and pctx.exchange_mode() == "a2a"
    assert pctx.active_mesh() is None and pctx.exchange_mode() == "psum"
    assert not pctx.seq_shard_active() and pctx.pp_microbatches() == 0
