"""ESMM, MMoE and PLE parity: the port (ml_function_tpu_torch) against the
JAX package on the CPU, with the JAX parameters copied across by key path,
the experts' per-layer lists included (``params/experts/w/0``,
``params/layers/0/gate_w/1``).

Bars as in tests/test_torch_interaction.py: logits and aux terms at rtol
1e-5, one step's gradients at 1e-3·max|g| or one bf16 step where both
packages return bf16 values (the towers' weights, ``ROADMAP.md`` R3). The
experts and gates are plain f32 products in both packages. The batch's
``click`` is drawn as the JAX bench draws it, max(label, Bernoulli(0.3)).
"""

import jax
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.features.synthetic import make_cvr_data as jax_make_cvr
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.serving import export_model as jax_export
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import (flat_params, params_from_numpy,
                                          params_to_numpy)
from ml_function_tpu_torch.features.synthetic import make_criteo_like, make_cvr_data
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.serving import export_model, load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

BATCH = 256
DATA = dict(n_rows=BATCH, n_dense=4, n_sparse=6, vocab_size=50, embed_dim=4, seed=1)
HP = {"n_experts": 3, "expert_hidden": (16, 12), "tower_hidden": (8,),
      "task_weights": (1.0, 0.5)}
HP_JSON = {k: list(v) if isinstance(v, tuple) else v for k, v in HP.items()}


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
    ok = err <= bar + (np.abs(want) * 2.0 ** -7 if both_bf16 else 0.0)
    assert ok.all(), f"max |err| {err.max()} (bar {bar}, bf16 values: {both_bf16})"


def _key_paths(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _data():
    fs, data = jax_make(**DATA)
    tfs, tdata = make_criteo_like(**DATA)
    assert tfs.fingerprint == fs.fingerprint
    rng = np.random.default_rng(2)
    click = np.maximum(data["label"],
                       (rng.uniform(size=BATCH) < 0.3).astype(np.float32))
    w = np.ones(BATCH, np.float32)
    w[-40:] = 0.0                     # a padded tail: the click BCE ignores it (R5)
    for d in (data, tdata):
        d["click"], d["weight"] = click, w
    return fs, data, tfs, tdata


@pytest.fixture(scope="module")
def jax_side():
    """The JAX MMoE's parameters, logits, aux terms, loss and gradients."""
    fs, data, _, _ = _data()
    jm = jax_get_model("mmoe", fs, **HP)
    params, state = jm.init(jax.random.PRNGKey(0))
    logits, _, aux = jm.apply(params, state, data)

    def jloss(p):
        return jloop.loss_fn(jm, p, state, data, None)[0]

    loss, grads = jax.value_and_grad(jloss)(params)
    return dict(model=jm, fs=fs, params=params, np_params=_np_tree(params),
                state=state, logits=np.asarray(logits),
                aux={k: np.asarray(v) for k, v in aux.items()},
                loss=float(loss), grads=_np_tree(grads))


def _port(jax_side):
    _, _, tfs, tdata = _data()
    tm = get_model("mmoe", tfs, device="cpu", **HP)
    params_from_numpy(tm, jax_side["np_params"])
    return tm, tfs, tdata


def test_logits_and_aux_match_jax(jax_side):
    tm, _, tdata = _port(jax_side)
    with torch.no_grad():
        got, state, aux = tm(tdata)
    assert got.shape == (BATCH,) and state == {}
    _close(got.numpy(), jax_side["logits"], 1e-5)
    assert set(aux) == set(jax_side["aux"]) == {"emb_l2", "click_bce"}
    for k, v in aux.items():
        _close(v.numpy(), jax_side["aux"][k], 1e-5)


def test_one_step_gradients_match_jax(jax_side):
    tm, _, tdata = _port(jax_side)
    total, _ = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    _close(total.item(), jax_side["loss"], 1e-5)
    names = set()
    for pname, p in tm.named_parameters():
        ref = jax_side["grads"]
        for k in pname.split("."):
            ref = ref[int(k)] if isinstance(ref, list) else ref[k]
        _grad_close(p.grad.numpy(), ref)
        names.add(pname)
    assert {"experts.w.0", "experts.w.1", "experts.b.1", "gates.w", "gates.b",
            "tower1.head.w"} <= names


def test_scoring_needs_no_click(jax_side, tmp_path):
    """Without ``click`` the forward emits no click term and the same
    logits; a scorer takes features alone."""
    tm, tfs, tdata = _port(jax_side)
    features = {k: tdata[k] for k in ("dense", "sparse")}
    with torch.no_grad():
        got, _, aux = tm(features)
    assert set(aux) == {"emb_l2"}
    _close(got.numpy(), jax_side["logits"], 1e-5)
    path = export_model(str(tmp_path / "m"), "mmoe", tfs, tm,
                        hyperparams=HP_JSON)
    scorer = load_scorer(path, batch_size=96, device="cpu")
    probs = scorer.predict_proba(features)
    want = 1.0 / (1.0 + np.exp(-jax_side["logits"].astype(np.float64)))
    assert probs.shape == (BATCH,) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-6)


def test_click_bce_is_the_unweighted_mean(jax_side):
    """R5: the secondary BCE is the plain mean over every row, the padded
    tail's included (the ``weight`` mask does not reach it), in both
    packages: flipping the tail's clicks moves it, and alike in both."""
    tm, _, tdata = _port(jax_side)
    flipped = dict(tdata, click=tdata["click"].copy())
    flipped["click"][-40:] = 1.0 - flipped["click"][-40:]
    with torch.no_grad():
        base = float(tm(tdata)[2]["click_bce"])
        moved = float(tm(flipped)[2]["click_bce"])
    _, _, want = jax_side["model"].apply(jax_side["params"], jax_side["state"], flipped)
    assert abs(moved - base) > 1e-4       # f32 noise is about 1e-7
    _close(moved, want["click_bce"], 1e-5)
    _close(base, jax_side["aux"]["click_bce"], 1e-5)


def test_bridge_takes_the_jax_mmoe_tree(jax_side, tmp_path):
    """F8: the JAX tree's experts are lists of arrays. ``params_from_numpy``
    takes the tree and the ``weights.npz`` keys of a JAX export
    (``params/experts/w/0``); ``params_to_numpy`` gives the JAX tree's key
    paths and lists back, and ``flat_params`` the JAX export's keys."""
    tm, tfs, tdata = _port(jax_side)
    back = params_to_numpy(tm)
    assert isinstance(back["experts"]["w"], list) and len(back["experts"]["w"]) == 2
    assert _key_paths(back) == _key_paths(jax_side["params"])
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(jax_side["np_params"])[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(b, a, err_msg=str(path))

    jax_export(str(tmp_path / "j"), "mmoe", jax_side["fs"], jax_side["params"],
               jax_side["state"], hyperparams=HP_JSON)
    with np.load(str(tmp_path / "j" / "weights.npz")) as arrays:
        npz = dict(arrays)
    assert "params/experts/w/0" in npz and set(flat_params(tm)) == set(npz)
    fresh = get_model("mmoe", tfs, device="cpu", **HP)
    params_from_numpy(fresh, npz)
    for (n, a), (_, b) in zip(tm.named_parameters(), fresh.named_parameters()):
        assert torch.equal(a, b), n
    scorer = load_scorer(str(tmp_path / "j"), batch_size=128, device="cpu")
    want = 1.0 / (1.0 + np.exp(-jax_side["logits"].astype(np.float64)))
    np.testing.assert_allclose(scorer.predict_proba(tdata), want, rtol=0, atol=1e-6)


def test_mmoe_parameter_shapes():
    tfs, _ = make_criteo_like(**DATA)
    tm = get_model("mmoe", tfs, device="cpu", generator=torch.Generator().manual_seed(1))
    shapes = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    in_dim = 6 * 4 + 4
    assert shapes["experts.w.0"] == (4, in_dim, 64)
    assert shapes["experts.b.0"] == (4, 64)
    assert shapes["gates.w"] == (2, in_dim, 4) and shapes["gates.b"] == (2, 4)
    assert "embedding.linear" not in shapes and "tower1.head.w" in shapes
    with torch.no_grad():
        assert float(tm.gates.b.abs().sum()) == 0.0
        limit = (6.0 / (in_dim + 64)) ** 0.5
        assert float(tm.experts.w[0].abs().max()) <= limit
        assert float(tm.experts.w[0].std()) == pytest.approx(limit / 3 ** 0.5, rel=0.1)


# ---- ESMM and PLE -----------------------------------------------------------
# The same bars, on make_cvr_data's impression-space batch (``click``, and a
# conversion ``label`` observed only on clicks), with a padded tail.

CVR = dict(n_rows=BATCH, n_dense=4, n_sparse=6, vocab_size=50, embed_dim=4, seed=3)
CVR_HP = {"esmm": {"hidden": (16, 8), "ctr_weight": 0.5},
          "ple": {"n_task_experts": 2, "n_shared_experts": 1, "n_layers": 2,
                  "expert_dim": 12, "tower_hidden": (8,), "task_weights": (1.0, 0.5)}}
CVR_AUX = {"esmm": {"emb_l2", "ctr_bce"}, "ple": {"emb_l2", "click_bce"}}
# the reference's PLE applies the last layer's shared gate and never reads
# it (R6): zero gradient in JAX, none in the port
CVR_UNREAD = {"esmm": set(), "ple": {"layers.1.shared_gate_w", "layers.1.shared_gate_b"}}


def _hp_json(hp):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in hp.items()}


def _cvr_data():
    fs, data = jax_make_cvr(**CVR)
    tfs, tdata = make_cvr_data(**CVR)
    assert tfs.fingerprint == fs.fingerprint
    w = np.ones(BATCH, np.float32)
    w[-40:] = 0.0
    for d in (data, tdata):
        d["weight"] = w
    return fs, data, tfs, tdata


@pytest.fixture(scope="module")
def cvr_side():
    """Per model: the JAX parameters, logits, aux terms, loss and gradients."""
    fs, data, _, _ = _cvr_data()
    out = {}
    for name, hp in CVR_HP.items():
        jm = jax_get_model(name, fs, **hp)
        params, state = jm.init(jax.random.PRNGKey(0))
        fn = jax.jit(jax.value_and_grad(
            lambda p: jloop.loss_fn(jm, p, state, data, None), has_aux=True))
        (loss, (logits, _, aux, _)), grads = fn(params)
        out[name] = dict(model=jm, fs=fs, params=params, np_params=_np_tree(params),
                         state=state, logits=np.asarray(logits),
                         aux={k: np.asarray(v) for k, v in aux.items()},
                         loss=float(loss), grads=_np_tree(grads))
    return out


def _cvr_port(cvr_side, name):
    _, _, tfs, tdata = _cvr_data()
    tm = get_model(name, tfs, device="cpu", **CVR_HP[name])
    params_from_numpy(tm, cvr_side[name]["np_params"])
    return tm, tfs, tdata


def _leaf(tree, pname):
    for k in pname.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_make_cvr_data_is_the_reference():
    fs, data, tfs, tdata = _cvr_data()
    assert tdata.keys() == data.keys()
    for k in data:
        assert tdata[k].dtype == data[k].dtype
        np.testing.assert_array_equal(tdata[k], data[k])
    assert (tdata["label"] <= tdata["click"]).all() and tdata["label"].any()


@pytest.mark.parametrize("name", sorted(CVR_HP))
def test_cvr_models_logits_and_aux_match_jax(cvr_side, name):
    tm, _, tdata = _cvr_port(cvr_side, name)
    with torch.no_grad():
        got, state, aux = tm(tdata)
    assert got.shape == (BATCH,) and state == {}
    _close(got.numpy(), cvr_side[name]["logits"], 1e-5)
    assert set(aux) == set(cvr_side[name]["aux"]) == CVR_AUX[name]
    for k, v in aux.items():
        _close(v.numpy(), cvr_side[name]["aux"][k], 1e-5)


@pytest.mark.parametrize("name", sorted(CVR_HP))
def test_cvr_models_one_step_gradients_match_jax(cvr_side, name):
    """Every parameter's gradient of the total loss; the parameters the
    reference never reads get none in the port and exactly zero in JAX."""
    tm, _, tdata = _cvr_port(cvr_side, name)
    total, _ = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    _close(total.item(), cvr_side[name]["loss"], 1e-5)
    names = set()
    for pname, p in tm.named_parameters():
        ref = _leaf(cvr_side[name]["grads"], pname)
        if pname in CVR_UNREAD[name]:
            assert p.grad is None and not np.asarray(ref).any(), pname
        else:
            _grad_close(p.grad.numpy(), ref)
        names.add(pname)
    assert _key_paths(cvr_side[name]["grads"]) == {n.replace(".", "/") for n in names}


@pytest.mark.parametrize("name", sorted(CVR_HP))
def test_cvr_models_score_without_click(cvr_side, name, tmp_path):
    """Features alone: no secondary BCE, the same logits, and a scorer from
    ``export_model`` → ``load_scorer(device='cpu')``."""
    tm, tfs, tdata = _cvr_port(cvr_side, name)
    features = {k: tdata[k] for k in ("dense", "sparse")}
    with torch.no_grad():
        got, _, aux = tm(features)
    assert set(aux) == {"emb_l2"}
    _close(got.numpy(), cvr_side[name]["logits"], 1e-5)
    path = export_model(str(tmp_path / "m"), name, tfs, tm,
                        hyperparams=_hp_json(CVR_HP[name]))
    probs = load_scorer(path, batch_size=96, device="cpu").predict_proba(features)
    want = 1.0 / (1.0 + np.exp(-cvr_side[name]["logits"].astype(np.float64)))
    assert probs.shape == (BATCH,) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-6)


def test_esmm_pctcvr_bounded_by_pctr(cvr_side):
    """pCTCVR = pCTR·pCVR ≤ pCTR, the CTR tower read alone."""
    tm, _, tdata = _cvr_port(cvr_side, "esmm")
    from ml_function_tpu_torch.models.multitask import _shared_input
    batch = tloop.to_device(tdata, "cpu")
    with torch.no_grad():
        pctcvr = torch.sigmoid(tm(batch)[0])
        pctr = torch.sigmoid(tm.ctr(_shared_input(tm, batch, 4)[0])[:, 0])
    assert bool((pctcvr <= pctr + 1e-6).all())
    assert bool((pctcvr < pctr).any())


@pytest.mark.parametrize("primary,other", [(0, 1), (1, 0)])
def test_ple_private_experts_untouched_by_other_task(primary, other):
    """The CGC routing invariant at one layer: task ``primary``'s logit
    gives exactly zero gradient to task ``other``'s private expert and gate,
    and a non-zero one to its own and the shared expert (expert 0 task 0's,
    1 task 1's, 2 shared)."""
    tfs, tdata = make_cvr_data(n_rows=64, n_dense=2, n_sparse=4, vocab_size=10,
                               embed_dim=4, seed=7)
    tm = get_model("ple", tfs, device="cpu", n_task_experts=1, n_shared_experts=1,
                   n_layers=1, expert_dim=8, tower_hidden=(8,),
                   generator=torch.Generator().manual_seed(0))
    captured = {}
    tower = getattr(tm, f"tower{primary}")
    hook = tower.register_forward_hook(lambda mod, inp, out: captured.setdefault("lg", out))
    tm(tloop.to_device(tdata, "cpu"), train=True)
    hook.remove()
    captured["lg"].square().mean().backward()
    layer = tm.layers[0]
    assert float(layer.w.grad[primary].abs().sum()) > 0
    assert float(layer.w.grad[2].abs().sum()) > 0
    assert float(layer.w.grad[other].abs().sum()) == 0.0
    assert float(layer.b.grad[other].abs().sum()) == 0.0
    assert layer.gate_w[other].grad is None and layer.gate_w[primary].grad is not None


def test_bridge_takes_the_jax_ple_tree(cvr_side, tmp_path):
    """PLE's ``layers`` is a list of dicts holding lists (``gate_w``): the
    bridge takes the JAX tree and a JAX export's ``weights.npz``
    (``params/layers/0/gate_w/1``) and gives the JAX key paths back."""
    side = cvr_side["ple"]
    tm, tfs, tdata = _cvr_port(cvr_side, "ple")
    back = params_to_numpy(tm)
    assert isinstance(back["layers"], list) and isinstance(back["layers"][0]["gate_w"], list)
    assert _key_paths(back) == _key_paths(side["params"])
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(side["np_params"])[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    hp = _hp_json(CVR_HP["ple"])
    jax_export(str(tmp_path / "j"), "ple", side["fs"], side["params"], side["state"],
               hyperparams=hp)
    with np.load(str(tmp_path / "j" / "weights.npz")) as arrays:
        npz = dict(arrays)
    assert "params/layers/0/gate_w/1" in npz and set(flat_params(tm)) == set(npz)
    scorer = load_scorer(str(tmp_path / "j"), batch_size=128, device="cpu")
    want = 1.0 / (1.0 + np.exp(-side["logits"].astype(np.float64)))
    np.testing.assert_allclose(scorer.predict_proba(tdata), want, rtol=0, atol=1e-6)


def test_cvr_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    tfs, _ = make_cvr_data(n_rows=16, n_sparse=3, vocab_size=5)
    for name in CVR_HP:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(name, tfs)
