"""DIN and DIEN: the port (ml_function_tpu_torch) against the JAX package on
the CPU, at 2 behavior sequences, dim 4, L 8, B 32, with the JAX weights
carried across by the bridge.

Routes: the scan route of both recurrences (the reference's default), and
the kernel route, where the port sets ``kernel = 'pallas'`` on ``gru1`` and
``gru2`` and the JAX DIEN is built with ``GRU(kd, kd, kernel='pallas')``
(the names ``GRU`` and ``AUGRU`` of ``ml_function_tpu.models.sequence``
patched; no file changes). The merge-scatter gradient K1 is taken by
patching ``_USE_MERGE_SCATTER`` in both packages (the flag is read at
import).

Bars: with ``ML_FUNCTION_TPU_F32_MATMUL=1`` logits and losses within 1e-5
and gradients within 1e-4·max|g|; on the bf16 path 1e-4 and 1e-3
(``ROADMAP.md`` R3). The max|g| is the tensor's own, except in the target
attention's MLP (``attn``), where it is the block's: the softmax over steps
does not see a shift of every score, so the gradient of the MLP's head bias
is zero up to rounding and that of its first-layer bias almost so (about
1e-6 of the block's largest), both residues of sums that cancel. Like
compares with like: the scan route's autograd
returns wh's gradient rounded to bf16 in both packages, the kernel route
keeps it in f32 in both.
"""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_function_tpu.models.sequence as jseq
import ml_function_tpu.ops.embedding as jemb
from ml_function_tpu.features.synthetic import make_behavior_data as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops.recurrent import GRU as JGRU
from ml_function_tpu.serving import Scorer as JaxScorer
from ml_function_tpu.serving import export_model as jax_export
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_behavior_data
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import embedding as temb
from ml_function_tpu_torch.ops.kernels import embedding_grad as teg
from ml_function_tpu_torch.ops.kernels import gru as tgru
from ml_function_tpu_torch.serving import load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

DATA_KW = dict(n_rows=32, n_items=30, n_cates=6, seq_len=8, embed_dim=4, seed=2)
MODELS = {"din": ("din", {"hidden": (16, 8)}),
          "dien": ("dien", {"hidden": (16, 8)}),
          "dien-aigru": ("dien", {"hidden": (16, 8), "mode": "aigru"})}
# (model, route): 'kernel' is the (AU)GRU kernel route with K1 on; DIN has
# no recurrence, so its 'kernel' case is K1 alone
CASES = [(m, r, f32) for m in MODELS for r in ("scan", "kernel")
         for f32 in (True, False)]


def _ids(cases):
    return [f"{m}-{r}-{'f32' if f else 'bf16'}" for m, r, f in cases]


@contextlib.contextmanager
def _jax_route(kernel: bool, f32: bool):
    """The JAX DIEN built with GRU(kernel='pallas') and the merge-scatter
    on (kernel), and the f32 matmul switch."""
    saved = (jseq.GRU, jseq.AUGRU, jemb._USE_MERGE_SCATTER,
             os.environ.get("ML_FUNCTION_TPU_F32_MATMUL"))
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1" if f32 else "0"
    if kernel:
        jseq.GRU = jseq.AUGRU = functools.partial(JGRU, kernel="pallas")
        jemb._USE_MERGE_SCATTER = True
    try:
        yield
    finally:
        jseq.GRU, jseq.AUGRU, jemb._USE_MERGE_SCATTER, env = saved
        if env is None:
            os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
        else:
            os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = env


def _jax_model(key):
    name, hp = MODELS[key]
    fs, data = jax_make(**DATA_KW)
    jm = jax_get_model(name, fs, **hp)
    params, state = jm.init(jax.random.PRNGKey(0))
    return fs, data, jm, jax.tree_util.tree_map(np.asarray, params), state


@pytest.fixture(scope="module")
def jax_side():
    """Per case: logits, aux, total loss and gradients of the JAX model
    (weight mask with a padded tail)."""
    out = {}
    for key, route, f32 in CASES:
        with _jax_route(route == "kernel", f32):
            _, data, jm, params, state = _jax_model(key)
            data = dict(data, weight=_weight())
            (total, (logits, _, aux, _)), grads = jax.value_and_grad(
                lambda p: jloop.loss_fn(jm, p, state, data, None), has_aux=True)(params)
        out[key, route, f32] = (params, np.asarray(logits),
                                {k: float(v) for k, v in aux.items()}, float(total),
                                jax.tree_util.tree_map(np.asarray, grads))
    return out


def _weight():
    w = np.ones(DATA_KW["n_rows"], np.float32)
    w[-5:] = 0.0
    return w


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _at(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def _port_model(key, params, route):
    name, hp = MODELS[key]
    fs, _ = make_behavior_data(**DATA_KW)
    tm = get_model(name, fs, device="cpu", **hp)
    params_from_numpy(tm, params)
    if route == "kernel" and name == "dien":
        tm.gru1.kernel = tm.gru2.kernel = "pallas"
    return tm


def test_make_behavior_data_is_the_reference():
    kw = dict(n_rows=200, n_items=40, n_cates=7, seq_len=12, seed=5)
    fs, data = make_behavior_data(**kw)
    jfs, jdata = jax_make(**kw)
    assert dataclasses.asdict(fs) == dataclasses.asdict(jfs)
    assert data.keys() == jdata.keys() and data["seq"].keys() == jdata["seq"].keys()
    for k in ("dense", "sparse", "label", "group"):
        assert data[k].dtype == jdata[k].dtype
        np.testing.assert_array_equal(data[k], jdata[k])
    for k in data["seq"]:
        np.testing.assert_array_equal(data["seq"][k], jdata["seq"][k])
    assert fs.total_vocab == 41 + 8 + 2 * 50


@pytest.mark.parametrize("key,route,f32", CASES, ids=_ids(CASES))
def test_loss_and_gradients_match_jax(jax_side, key, route, f32, monkeypatch):
    """Logits, the aux terms and the total loss of one batch, and the
    gradient of every parameter; on the kernel route the CPU runs the
    plain versions of all three kernels and launches none."""
    params, want_logits, want_aux, want_total, want_grads = jax_side[key, route, f32]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    monkeypatch.setattr(temb, "_USE_MERGE_SCATTER", route == "kernel")
    fwd_bar, grad_bar = (1e-5, 1e-4) if f32 else (1e-4, 1e-3)
    tm = _port_model(key, params, route)
    _, tdata = make_behavior_data(**DATA_KW)
    tdata["weight"] = _weight()
    tgru.gru_fwd_launches = tgru.gru_bwd_launches = teg.merge_scatter_launches = 0
    calls = []
    real = teg.FusedGather.backward
    monkeypatch.setattr(teg.FusedGather, "backward",
                        staticmethod(lambda ctx, ct: calls.append(1) or real(ctx, ct)))
    total, (logits, _, aux, _) = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    assert (tgru.gru_fwd_launches, tgru.gru_bwd_launches, teg.merge_scatter_launches) == (0, 0, 0)
    assert len(calls) == (2 if route == "kernel" else 0)   # one per sequence
    assert set(aux) == set(want_aux)
    _close(logits.detach(), want_logits, fwd_bar)
    for k, v in aux.items():
        _close(v.item(), want_aux[k], fwd_bar)
    _close(total.item(), want_total, fwd_bar)
    names = {n for n, _ in tm.named_parameters()}
    assert names == {".".join(str(k.key) for k in path) for path, _ in
                     jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    attn_max = max(float(np.abs(_at(want_grads, n)).max())
                   for n in names if n.startswith("attn."))
    for pname, p in tm.named_parameters():
        want = _at(want_grads, pname)
        scale = attn_max if pname.startswith("attn.") else float(np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=grad_bar,
                                   atol=grad_bar * scale, err_msg=pname)


def test_dien_interest_core_is_the_forward_s():
    _, _, jm, params, _ = _jax_model("dien")
    tm = _port_model("dien", params, "scan")
    _, tdata = make_behavior_data(**DATA_KW)
    from ml_function_tpu_torch.models.base import behavior_inputs
    batch = tloop.to_device(tdata, "cpu")
    with torch.no_grad():
        cand, beh, mask, _, _ = behavior_inputs(tm.embedding, batch, ("item", "cate"),
                                                ("hist_item", "hist_cate"))
        final, aux = tm.interest(cand, beh, mask)
        _, _, fwd_aux = tm(batch)
    assert final.shape == (DATA_KW["n_rows"], 8)
    assert aux.item() == fwd_aux["aux_loss"].item()


@pytest.mark.parametrize("route", ["scan", "kernel"])
def test_jax_dien_export_scores_the_same_in_the_port(route, tmp_path):
    """A directory the JAX ``export_model`` wrote for DIEN loads into the
    port's ``load_scorer``; ``predict_proba`` hands the model numpy
    batches whose ``seq`` is a nested dict (the ``Model.forward`` repair).
    40 rows in batches of 16: the third is padded."""
    _, data = jax_make(**dict(DATA_KW, n_rows=40))
    hp = {"hidden": [16, 8], "mode": "augru"}
    with _jax_route(route == "kernel", f32=False):
        fs, _, jm, params, state = _jax_model("dien")
        want = JaxScorer(jm, params, state, batch_size=16).predict_proba(data)
    jax_export(str(tmp_path / "m"), "dien", fs, params, state, hyperparams=hp)
    scorer = load_scorer(str(tmp_path / "m"), batch_size=16, device="cpu")
    assert scorer.model.name == "DIEN" and scorer.model.gru1.kernel == "scan"
    if route == "kernel":
        scorer.model.gru1.kernel = scorer.model.gru2.kernel = "pallas"
    got = scorer.predict_proba(data)
    assert got.shape == (40,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_dien_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    fs, _, _, params, state = _jax_model("dien")
    jax_export(str(tmp_path / "m"), "dien", fs, params, state,
               hyperparams={"hidden": [16, 8]})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_scorer(str(tmp_path / "m"))
    tfs, _ = make_behavior_data(**DATA_KW)
    for name in ("din", "dien"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(name, tfs)
