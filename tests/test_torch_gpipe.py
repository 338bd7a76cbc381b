"""The GPipe pipeline of the port (``parallel/pipeline.py``) and AutoInt's
pipelined block stack on gloo ranks, against the sequential stages and the
JAX package on a mesh of the same shape.

The port runs in 4 spawned processes (one spawn for the file,
``torch_parallel_worker.gpipe_cases``) on (1, 4) and (2, 2) meshes; the JAX
side runs here on 4 of the 8 virtual CPU devices, with
``ML_FUNCTION_TPU_F32_MATMUL=1`` on both.

Bars, each beside its reason:
- ``make_pipeline``: the output within rtol 1e-5, atol 1e-6 of the
  sequential stages', and the stacked parameters' gradients within rtol
  1e-4, atol 1e-6 of theirs (the JAX tests' bars: the hand-offs move values
  and sum nothing, but the global mean's gradient is summed over ranks);
- one pipelined AutoInt SGD step (4 blocks over 2 stages, 2 microbatches)
  against the JAX package's at the same mesh: the loss within rtol 1e-6, the
  logits rtol 1e-5, atol 1e-6, every parameter rtol 2e-3, atol 1e-5, the
  bars of the JAX test that holds that step against the unpipelined one;
  and every parameter's change in the step within 1e-3 of its leaf's
  largest change, against the JAX package's and the port's unpipelined
  step's (3.7e-5 and 1.2e-5 measured; a stage gradient left unsummed or
  summed twice gives 1.0, which the parameters' own bar can miss, a
  change lr·g being far below rtol 2e-3 of a parameter).
"""

import os
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

import torch_parallel_worker as worker
from ml_function_tpu.features.synthetic import make_criteo_like as jax_criteo
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ml_function_tpu.parallel.train import create_sharded_state as jax_sharded_state
from ml_function_tpu.parallel.train import make_sharded_train_step as jax_sharded_step
from ml_function_tpu.parallel.train import shard_batch as jax_shard_batch
from ml_function_tpu.train.loop import iter_batches as jax_iter_batches
from ml_function_tpu_torch.parallel.launch import spawn
from ml_function_tpu_torch.parallel.mesh import Mesh
from ml_function_tpu_torch.parallel.pipeline import (make_pipeline, pipeline_spec_tree,
                                                     stack_stage_params)

torch.set_num_threads(1)

CRITEO = dict(n_rows=64, n_dense=2, n_sparse=5, vocab_size=17, embed_dim=8, seed=2)


@pytest.fixture(scope="module", autouse=True)
def _f32():
    old = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    yield
    if old is None:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
    else:
        os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = old


def _params(n_stages, d, seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(n_stages, d, d)) * 0.5).astype(np.float32),
            "b": (rng.normal(size=(n_stages, d)) * 0.1).astype(np.float32)}


def _sequential(params, x):
    """The stages one after another, and the gradient of mean(y²) for each
    stacked leaf (torch, on the whole batch)."""
    p = {k: torch.tensor(v).requires_grad_() for k, v in params.items()}
    y = torch.tensor(x)
    for s in range(p["w"].shape[0]):
        y = worker._stage_fn({k: v[s] for k, v in p.items()}, y)
    y.square().mean().backward()
    return y.detach().numpy(), {k: v.grad.numpy() for k, v in p.items()}


PIPES = {"stages4_m4": dict(mesh=(1, 4), d=8, batch=16, m=4, seed=0),
         "stages4_m2": dict(mesh=(1, 4), d=4, batch=8, m=2, seed=2),
         "stages2_data2_m4": dict(mesh=(2, 2), d=8, batch=32, m=4, seed=4)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    io_dir = str(tmp_path_factory.mktemp("gpipe"))
    inputs = {"pipelines": {}, "steps": {}}
    want = {"pipelines": {}}
    for name, c in PIPES.items():
        params = _params(c["mesh"][1], c["d"], c["seed"])
        x = np.random.default_rng(c["seed"] + 1).normal(size=(c["batch"], c["d"])).astype(
            np.float32)
        inputs["pipelines"][name] = {"params": params, "x": x, "m": c["m"], "mesh": c["mesh"]}
        want["pipelines"][name] = _sequential(params, x)

    mesh = jax_make_mesh(data=2, model=2, devices=jax.devices()[:4])
    fs, data = jax_criteo(**CRITEO)
    model = jax_get_model("autoint", fs, n_layers=4)
    # SGD: updates are linear in the gradients (the JAX test's reason)
    opt = optax.sgd(1e-2)
    batch = next(jax_iter_batches(data, 64))
    sts = jax_sharded_state(model, jax.random.PRNGKey(0), opt, mesh)
    params = jax.tree_util.tree_map(np.asarray, sts.params)
    step = jax_sharded_step(model, opt, mesh, donate=False, pp_microbatches=2)
    sts2, out = step(sts, jax_shard_batch(batch, mesh))
    want["autoint"] = {"loss": float(out["loss"]), "logits": np.asarray(out["logits"]),
                       "params": jax.tree_util.tree_map(np.asarray, sts2.params),
                       "init": params}
    for name, micro in (("autoint_pp2", 2), ("autoint_unpiped", 0)):
        inputs["steps"][name] = {"model": "autoint", "data": "make_criteo_like",
                                 "data_kw": CRITEO, "hp": {"n_layers": 4},
                                 "opt": ("sgd", 1e-2), "params": params, "batch": batch,
                                 "pp_microbatches": micro, "mesh": (2, 2)}
    with open(os.path.join(io_dir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    spawn(worker.gpipe_cases, 4, (io_dir,), store_dir=io_dir)
    port = {}
    for r in range(4):
        with open(os.path.join(io_dir, f"results_{r}.pkl"), "rb") as f:
            port[r] = pickle.load(f)
    return want, port


@pytest.mark.parametrize("name", sorted(PIPES))
def test_pipeline_matches_sequential_stages(runs, name):
    """The pipeline's output and its stacked parameters' gradients equal the
    sequential stages' on every rank (4 stages; 2 stages composed with 2
    data shards)."""
    want, port = runs
    y, grads = want["pipelines"][name]
    for r in range(4):
        got = port[r]["pipelines"][name]
        np.testing.assert_allclose(got["y"], y, rtol=1e-5, atol=1e-6)
        for k, g in grads.items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=1e-4, atol=1e-6, err_msg=k)


def _flat(tree, prefix=""):
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _update_gap(init, got, want):
    """The worst leaf's |Δgot − Δwant| over its max |Δwant|, Δ its change
    from ``init`` in the step (f64, ``want``'s and ``init``'s padded rows
    cut), each max floored at 1e-3 of the largest change of any leaf: a leaf
    whose gradient is zero but for rounding moves by noise alone."""
    delta = {}
    for k, g in got.items():
        n = g.shape[0] if g.ndim else None
        w0 = np.asarray(init[k])[:n].astype(np.float64)
        delta[k] = (g - w0, np.asarray(want[k])[:n] - w0)
    floor = 1e-3 * max(np.abs(dw).max(initial=0.0) for _, dw in delta.values())
    return max(np.abs(dg - dw).max(initial=0.0) / max(np.abs(dw).max(initial=0.0), floor)
               for dg, dw in delta.values())


def test_pipelined_autoint_step_matches_jax(runs):
    """One AutoInt SGD step with 4 blocks over 2 stages and 2 microbatches
    on a (2, 2) mesh equals the JAX package's pipelined step: the loss, the
    logits and every parameter after it; the unpipelined step of the port
    meets the same bars (the pipeline changes the route, not the result)."""
    want, port = runs
    w = want["autoint"]
    wp = _flat(w["params"])
    for name in ("autoint_pp2", "autoint_unpiped"):
        got = port[0]["steps"][name]
        np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["logits"], w["logits"], rtol=1e-5, atol=1e-6)
        gp = _flat(got["params"])
        assert sorted(gp) == sorted(wp)
        for k, v in gp.items():
            np.testing.assert_allclose(v, wp[k][:v.shape[0]], rtol=2e-3, atol=1e-5,
                                       err_msg=f"{name} {k}")
        assert _update_gap(_flat(w["init"]), gp, wp) < 1e-3, name
    # the pipelined step's changes against the port's unpipelined step's
    assert _update_gap(_flat(w["init"]), _flat(port[0]["steps"]["autoint_pp2"]["params"]),
                       _flat(port[0]["steps"]["autoint_unpiped"]["params"])) < 1e-3
    # every rank of a model group holds every stage's blocks, updated alike
    for r in range(1, 4):
        other = _flat(port[r]["steps"]["autoint_pp2"]["params"])
        for k, v in _flat(port[0]["steps"]["autoint_pp2"]["params"]).items():
            np.testing.assert_array_equal(other[k], v, err_msg=k)


def test_pipeline_bad_microbatch_split():
    """8 rows do not divide into 2 data shards × 3 microbatches."""
    mesh = Mesh(2, 4, (0, 0), tuple(range(8)), None, None, torch.device("cpu"))
    pipe = make_pipeline(mesh, worker._stage_fn, n_microbatches=3)
    params = {k: torch.tensor(v) for k, v in _params(4, 4, 0).items()}
    with pytest.raises(ValueError, match="batch 8 must divide into 2 data shards × 3"):
        pipe(params, torch.zeros((4, 4)))


def test_pipeline_spec_tree_marks_stage_axis():
    stacked = stack_stage_params([{"w": torch.zeros(4, 4), "b": torch.zeros(4)}
                                  for _ in range(4)])
    assert stacked["w"].shape == (4, 4, 4)
    specs = pipeline_spec_tree(stacked)
    assert specs["w"] == ("model", None, None)
    assert specs["b"] == ("model", None)


def test_autoint_refuses_an_uneven_split():
    """Three blocks over two stages raise the reference's ValueError."""
    from ml_function_tpu_torch.features.synthetic import make_criteo_like
    from ml_function_tpu_torch.models import get_model
    from ml_function_tpu_torch.parallel.context import sharded_embeddings
    fs, data = make_criteo_like(n_rows=8, n_dense=0, n_sparse=3, vocab_size=7, embed_dim=4)
    model = get_model("autoint", fs, device="cpu", n_layers=3)
    mesh = Mesh(1, 2, (0, 0), (0, 1), None, None, torch.device("cpu"))
    batch = {k: torch.as_tensor(v[:4]) for k, v in data.items()}
    with pytest.raises(ValueError, match="needs n_layers divisible"):
        with sharded_embeddings(mesh, pp_microbatches=2):
            model(batch)
