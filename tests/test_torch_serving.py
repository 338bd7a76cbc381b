"""Serving parity: a directory written by the JAX package's ``export_model``
scores the same in the port's ``load_scorer``, and the bridge copies weights
by key path, exactly and strictly.

Scores are sigmoids of logits that agree to about 1e-7 relative (same bf16
rounding sites, f32 sums in another order), so atol 1e-4 is loose by three
orders of magnitude and still far below any modelling difference.
"""

import jax
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.serving import Scorer as JaxScorer
from ml_function_tpu.serving import export_model as jax_export
from ml_function_tpu.serving import load_scorer as jax_load_scorer
from ml_function_tpu.train.loop import iter_batches as jax_iter_batches
from ml_function_tpu_torch.bridge import params_from_numpy, params_to_numpy
from ml_function_tpu_torch.features.schema import criteo_feature_set
from ml_function_tpu_torch.features.synthetic import \
    make_criteo_like as make_criteo_like_torch
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.serving import export_model, load_scorer
from ml_function_tpu_torch.train.loop import iter_batches

torch.set_num_threads(1)

HP = {"xdeepfm": {"cin_hidden": [128], "hidden": [16, 8]},
      "deepfm": {"hidden": [16, 8]},
      "autoint": {"n_layers": 2, "num_heads": 2, "head_dim": 16}}


def _jax_model(name, seed=0):
    fs, data = make_criteo_like(n_rows=600, n_dense=4, n_sparse=6,
                                vocab_size=50, embed_dim=4, seed=seed)
    hp = {k: tuple(v) if isinstance(v, list) else v for k, v in HP[name].items()}
    model = jax_get_model(name, fs, **hp)
    params, state = model.init(jax.random.PRNGKey(seed))
    return fs, data, model, params, state


def _key_paths(params):
    return {"/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("name", ["xdeepfm", "deepfm"])
def test_jax_export_scores_the_same_in_the_port(name, tmp_path):
    fs, data, model, params, state = _jax_model(name)
    want = JaxScorer(model, params, state, batch_size=256).predict_proba(data)
    jax_export(str(tmp_path / "m"), name, fs, params, state,
               hyperparams=HP[name])
    scorer = load_scorer(str(tmp_path / "m"), batch_size=256, device="cpu")
    got = scorer.predict_proba(data)      # 600 rows: the third batch is padded
    assert got.shape == (600,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    unlabeled = {k: v for k, v in data.items() if k != "label"}
    np.testing.assert_array_equal(scorer.predict_proba(unlabeled), got)


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("f32,atol", [("1", 1e-5), ("0", 1e-4)])
def test_jax_autoint_export_scores_the_same_in_the_port(flag, f32, atol,
                                                        tmp_path, monkeypatch):
    """AutoInt's hyperparameters travel in model.json; the port scores the
    JAX export on the small-L (flag 0) and the field-attention route (flag
    1). With ``ML_FUNCTION_TPU_F32_MATMUL=1`` the scores agree within 1e-5.
    With the bf16 sites on, an attention output summed in another order can
    round to the neighbouring bf16 value before a projection (2^-8
    relative), which moves a few of the 600 scores past 1e-5: atol 1e-4,
    as for the other models."""
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", flag)
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", f32)
    fs, data, model, params, state = _jax_model("autoint")
    want = JaxScorer(model, params, state, batch_size=256).predict_proba(data)
    jax_export(str(tmp_path / "m"), "autoint", fs, params, state,
               hyperparams=HP["autoint"])
    scorer = load_scorer(str(tmp_path / "m"), batch_size=256, device="cpu")
    assert scorer.model.name == "AutoInt" and scorer.model.mha1.hd == 16
    got = scorer.predict_proba(data)      # 600 rows: the third batch is padded
    assert got.shape == (600,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_port_export_loads_in_jax(tmp_path):
    fs, data, _, _, _ = _jax_model("xdeepfm", seed=1)
    tfs, _ = make_criteo_like_torch(n_rows=8, n_dense=4, n_sparse=6,
                                    vocab_size=50, embed_dim=4)
    tm = get_model("xdeepfm", tfs, device="cpu",
                   generator=torch.Generator().manual_seed(1),
                   **{k: tuple(v) for k, v in HP["xdeepfm"].items()})
    export_model(str(tmp_path / "t"), "xdeepfm", tfs, tm,
                 hyperparams=HP["xdeepfm"])
    want = load_scorer(str(tmp_path / "t"), batch_size=256,
                       device="cpu").predict_proba(data)
    got = jax_load_scorer(str(tmp_path / "t"), batch_size=256).predict_proba(data)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bridge_round_trip_is_exact_with_the_jax_key_set():
    _, _, _, params, _ = _jax_model("xdeepfm")
    tree = jax.tree_util.tree_map(np.asarray, params)
    fs = make_criteo_like(n_rows=1, n_dense=4, n_sparse=6, vocab_size=50,
                          embed_dim=4)[0]
    tfs = criteo_feature_set([s.vocab_size for s in fs.sparse], n_dense=4,
                             embed_dim=4)
    tm = get_model("xdeepfm", tfs, device="cpu",
                   **{k: tuple(v) for k, v in HP["xdeepfm"].items()})
    params_from_numpy(tm, tree)
    back = params_to_numpy(tm)
    assert _key_paths(back) == _key_paths(params)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(tree)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    assert {n.replace(".", "/") for n, _ in tm.named_parameters()} == \
        _key_paths(params)


def test_bridge_is_strict():
    fs = criteo_feature_set([5, 5], n_dense=1, embed_dim=4)
    tm = get_model("deepfm", fs, device="cpu", hidden=(4,))
    tree = params_to_numpy(tm)
    missing = {k: v for k, v in tree.items() if k != "bias"}
    with pytest.raises(KeyError, match="missing.*bias"):
        params_from_numpy(tm, missing)
    with pytest.raises(KeyError, match="unexpected.*extra"):
        params_from_numpy(tm, {**tree, "extra": np.zeros(1, np.float32)})
    bad = {**tree, "bias": np.zeros((2,), np.float32)}
    with pytest.raises(ValueError, match="bias"):
        params_from_numpy(tm, bad)
    # running state crosses too (BatchNorm buffers), as strictly: a state
    # key the model has no buffer for raises
    with pytest.raises(KeyError, match="state keys differ.*unexpected.*mlp/layer0/mean"):
        params_from_numpy(tm, {"params/bias": tree["bias"],
                               "state/mlp/layer0/mean": np.zeros(4)})


def test_load_scorer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    fs, _, _, params, state = _jax_model("deepfm")
    jax_export(str(tmp_path / "m"), "deepfm", fs, params, state,
               hyperparams=HP["deepfm"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_scorer(str(tmp_path / "m"))


@pytest.mark.parametrize("mode,exc", [("int8", FileNotFoundError),
                                      ("fp4", ValueError)])
def test_load_scorer_quantize_modes(mode, exc, tmp_path):
    """'int8' is a mode (an empty directory then has no model to load);
    any other raises ValueError before the directory is read."""
    with pytest.raises(exc):
        load_scorer(str(tmp_path), quantize=mode, device="cpu")


@pytest.mark.parametrize("n,batch_size,drop_last", [(10, 4, False),
                                                    (10, 4, True), (8, 4, False)])
def test_iter_batches_matches_jax(n, batch_size, drop_last):
    rng = np.random.default_rng(5)
    data = {"dense": rng.normal(size=(n, 2)).astype(np.float32),
            "sparse": rng.integers(0, 9, (n, 3)).astype(np.int32),
            "label": rng.integers(0, 2, n).astype(np.float32),
            "seq": {"hist": rng.integers(0, 9, (n, 5)).astype(np.int32)}}
    got = list(iter_batches(data, batch_size, shuffle=True, seed=3,
                            drop_last=drop_last))
    want = list(jax_iter_batches(data, batch_size, shuffle=True, seed=3,
                                 drop_last=drop_last))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("dense", "sparse", "label", "weight"):
            np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(g["seq"]["hist"], w["seq"]["hist"])
