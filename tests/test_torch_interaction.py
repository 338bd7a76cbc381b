"""DLRM and FiBiNET parity: the port (ml_function_tpu_torch) against the JAX
package on the CPU, with the JAX parameters copied across by key path.

Bars, as in tests/test_torch_models.py and tests/test_torch_train.py:
logits and ``emb_l2`` at rtol 1e-5 (both packages round the towers' matmul
inputs to bf16 at the same sites and sum in f32, so they differ by the f32
summation order, about 1e-7 relative; a missed or extra bf16 rounding shows
at about 4e-3), and one step's gradient of every parameter at 1e-3·max|g|,
or one bf16 step where both packages return bf16 values (the ``bf16_matmul``
weights' gradients, ``ROADMAP.md`` R3). The JAX side runs once for the
module; the cases stay small (B 256, 6 fields, dim 4) so that the JAX
compile of FiBiNET takes seconds.
"""

import jax
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.serving import export_model, load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

BATCH = 256
DATA = dict(n_rows=BATCH, n_sparse=6, vocab_size=50, embed_dim=4, seed=1)
CASES = {
    "dlrm_dense": ("dlrm", 4, {"bottom": (8,), "top": (16, 8)}),
    "dlrm_no_dense": ("dlrm", 0, {"bottom": (8,), "top": (16, 8)}),
    "fibinet_each": ("fibinet", 4, {"bilinear_type": "each", "hidden": (16, 8)}),
    "fibinet_all": ("fibinet", 4, {"bilinear_type": "all", "hidden": (16, 8)}),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bf16(x):
    return torch.tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _grad_close(got, want):
    """1e-3·max|g|, or one bf16 step where both are bf16 values."""
    want = np.asarray(want)
    bar = 1e-3 * float(np.abs(want).max())
    err = np.abs(got - want)
    both_bf16 = (np.array_equal(_bf16(got), got) and np.array_equal(_bf16(want), want))
    step = np.abs(want) * 2.0 ** -7
    ok = err <= bar + (step if both_bf16 else 0.0)
    assert ok.all(), f"max |err| {err.max()} (bar {bar}, bf16 values: {both_bf16})"


def _data(n_dense):
    fs, data = jax_make(n_dense=n_dense, **DATA)
    tfs, tdata = make_criteo_like(n_dense=n_dense, **DATA)
    assert tfs.fingerprint == fs.fingerprint
    w = np.ones(BATCH, np.float32)
    w[-40:] = 0.0                     # a padded tail the loss must mask out
    data["weight"] = tdata["weight"] = w
    return fs, data, tfs, tdata


@pytest.fixture(scope="module")
def jax_side():
    """Each case's JAX parameters, logits, emb_l2, loss and gradients."""
    out = {}
    for case, (name, n_dense, hp) in CASES.items():
        fs, data, _, _ = _data(n_dense)
        jm = jax_get_model(name, fs, **hp)
        params, state = jm.init(jax.random.PRNGKey(0))
        logits, _, aux = jm.apply(params, state, {"dense": data["dense"],
                                                  "sparse": data["sparse"]})

        def jloss(p):
            return jloop.loss_fn(jm, p, state, data, None)[0]

        loss, grads = jax.value_and_grad(jloss)(params)
        out[case] = dict(params=_np_tree(params), logits=np.asarray(logits),
                         emb_l2=np.asarray(aux["emb_l2"]), loss=float(loss),
                         grads=_np_tree(grads))
    return out


def _port(case, jax_side):
    name, n_dense, hp = CASES[case]
    _, _, tfs, tdata = _data(n_dense)
    tm = get_model(name, tfs, device="cpu", **hp)
    params_from_numpy(tm, jax_side[case]["params"])
    return tm, tfs, tdata


@pytest.mark.parametrize("case", list(CASES))
def test_logits_and_emb_l2_match_jax(case, jax_side):
    tm, _, tdata = _port(case, jax_side)
    with torch.no_grad():
        got, state, aux = tm({"dense": tdata["dense"], "sparse": tdata["sparse"]})
    assert got.shape == (BATCH,) and state == {}
    _close(got.numpy(), jax_side[case]["logits"], 1e-5)
    _close(aux["emb_l2"].numpy(), jax_side[case]["emb_l2"], 1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_one_step_gradients_match_jax(case, jax_side):
    tm, _, tdata = _port(case, jax_side)
    total, _ = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    _close(total.item(), jax_side[case]["loss"], 1e-5)
    want = jax_side[case]["grads"]
    for pname, p in tm.named_parameters():
        ref = want
        for k in pname.split("."):
            ref = ref[k]
        _grad_close(p.grad.numpy(), ref)


@pytest.mark.parametrize("case", ["dlrm_dense", "fibinet_each"])
def test_export_and_load_scorer_round_trip(case, jax_side, tmp_path):
    name, _, hp = CASES[case]
    tm, tfs, tdata = _port(case, jax_side)
    path = export_model(str(tmp_path / case), name, tfs, tm, hyperparams=hp)
    scorer = load_scorer(path, batch_size=96, device="cpu")
    got = scorer.predict_proba({"dense": tdata["dense"], "sparse": tdata["sparse"]})
    want = 1.0 / (1.0 + np.exp(-jax_side[case]["logits"].astype(np.float64)))
    assert got.shape == (BATCH,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case,keys", [
    ("dlrm_dense", {"embedding.table", "bottom.layer0.dense.w", "bottom.layer0.dense.b",
                    "bottom.layer1.dense.w", "bottom.layer1.dense.b"}),
    ("dlrm_no_dense", {"embedding.table"}),
    ("fibinet_each", {"embedding.table", "embedding.linear", "se.w1", "se.w2",
                      "bilinear_w", "bias", "dense_linear.dense.w", "dense_linear.dense.b"}),
])
def test_parameter_tree_is_the_reference_tree(case, keys, jax_side):
    """Every JAX leaf has its parameter (``params_from_numpy`` is strict both
    ways), and the keys that differ between the models are there or not."""
    tm, _, _ = _port(case, jax_side)
    names = {n for n, _ in tm.named_parameters()}
    assert keys <= names
    assert not any(n.startswith("bottom") for n in names) or case == "dlrm_dense"
    assert ("embedding.linear" in names) == case.startswith("fibinet")


def test_fibinet_weights_start_at_their_reference_scales():
    tfs, _ = make_criteo_like(n_dense=2, **DATA)
    tm = get_model("fibinet", tfs, device="cpu", hidden=(8,),
                   generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        assert float(tm.bilinear_w.std()) == pytest.approx(0.05, rel=0.2)
        assert float(tm.se.w1.std()) == pytest.approx(0.1, rel=0.4)
        assert float(tm.bias) == 0.0 and tuple(tm.bilinear_w.shape) == (6, 4, 4)


def test_fibinet_rejects_an_unknown_bilinear_type():
    tfs, _ = make_criteo_like(n_dense=2, **DATA)
    with pytest.raises(ValueError, match="bilinear_type 'field'"):
        get_model("fibinet", tfs, device="cpu", bilinear_type="field")
