"""Interaction-family parity: the port (ml_function_tpu_torch) against the
JAX package on the CPU, with the JAX parameters copied across by key path:
DLRM, FiBiNET, LR, FM, FFM, FwFM, PNN, DeepCross, Wide&Deep, DCN v1 and v2,
NFM, AFM and FNN, and the interaction ops they are built of.

Bars, as in tests/test_torch_models.py and tests/test_torch_train.py:
logits and ``emb_l2`` at rtol 1e-5 (both packages round the towers' matmul
inputs to bf16 at the same sites and sum in f32, so they differ by the f32
summation order, about 1e-7 relative; a missed or extra bf16 rounding shows
at about 4e-3), and one step's gradient of every parameter at 1e-3·max|g|,
or one bf16 step where both packages return bf16 values (the ``bf16_matmul``
weights' gradients, ``ROADMAP.md`` R3). A parameter the forward never reads
(PNN's ``outer.kernel``, the ``linear`` table of PNN, DeepCross and DCN:
``ROADMAP.md`` R6) gets no gradient in the port and must get exactly zero in
the JAX package. The JAX side runs once for the module; the cases stay small
(B 256, 6 fields, dim 4) so that the JAX compile of FiBiNET takes seconds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import fnn_from_fm as jax_fnn_from_fm
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops import embedding as jembedding
from ml_function_tpu.ops import interactions as jinteractions
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import fnn_from_fm, get_model
from ml_function_tpu_torch.ops import embedding as tembedding
from ml_function_tpu_torch.ops import interactions as tinteractions
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
    "lr": ("lr", 4, {}),
    "fm": ("fm", 4, {}),
    "ffm": ("ffm", 4, {"ffm_dim": 3}),
    "fwfm": ("fwfm", 4, {}),
    "fwfm_deep": ("fwfm", 4, {"hidden": (16, 8)}),
    "pnn": ("pnn", 4, {"hidden": (16, 8)}),
    "pnn_inner": ("pnn", 4, {"hidden": (16, 8), "use_outer": False}),
    # three layers: the second adds a projected skip from the input
    "deepcross": ("deepcross", 4, {"hidden": (16, 12, 8)}),
    "wide_deep": ("wide_deep", 4, {"hidden": (16, 8)}),
    "dcn_v1": ("dcn", 4, {"hidden": (16, 8)}),
    "dcn_v2": ("dcn", 4, {"hidden": (16, 8), "version": 2}),
    "nfm": ("nfm", 4, {"hidden": (16, 8)}),
    "afm": ("afm", 0, {"attn_dim": 8}),
    "fnn": ("fnn", 4, {"hidden": (16, 8)}),
}
# parameters the forward never reads (R6): no gradient in the port
UNREAD = {"pnn": {"embedding.linear", "outer.kernel"},
          "pnn_inner": {"embedding.linear"}, "deepcross": {"embedding.linear"},
          "dcn_v1": {"embedding.linear"}, "dcn_v2": {"embedding.linear"}}


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
                         aux={k: np.asarray(v) for k, v in aux.items()},
                         loss=float(loss), grads=_np_tree(grads))
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
    assert aux.keys() == jax_side[case]["aux"].keys()   # LR has no emb_l2
    for k, v in aux.items():
        _close(v.numpy(), jax_side[case]["aux"][k], 1e-5)


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
        if pname in UNREAD.get(case, ()):
            assert p.grad is None and not np.any(ref), pname
        else:
            _grad_close(p.grad.numpy(), ref)


@pytest.mark.parametrize("case", ["dlrm_dense", "fibinet_each", "ffm"])
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
    ("lr", {"embedding.linear", "bias", "dense_linear.dense.w", "dense_linear.dense.b"}),
    ("ffm", {"embedding.linear", "ffm", "bias", "dense_linear.dense.w",
             "dense_linear.dense.b"}),
    ("pnn", {"embedding.table", "embedding.linear", "outer.kernel", "mlp.head.w"}),
    ("deepcross", {"embedding.table", "embedding.linear", "mlp.res1.w"}),
    ("dcn_v1", {"embedding.table", "cross.layer2.w", "cross.layer2.b", "head.w"}),
])
def test_parameter_tree_is_the_reference_tree(case, keys, jax_side):
    """Every JAX leaf has its parameter (``params_from_numpy`` is strict both
    ways), and the keys that differ between the models are there or not:
    DLRM's store has no ``linear`` and LR's and FFM's no ``table``."""
    tm, _, _ = _port(case, jax_side)
    names = {n for n, _ in tm.named_parameters()}
    assert keys <= names
    assert not any(n.startswith("bottom") for n in names) or case == "dlrm_dense"
    assert ("embedding.linear" in names) == (not case.startswith("dlrm"))
    assert ("embedding.table" in names) == (case not in ("lr", "ffm"))


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


def test_table_shapes_of_the_new_models(jax_side):
    tm, tfs, _ = _port("ffm", jax_side)
    assert tuple(tm.ffm.shape) == (tfs.total_vocab, 6 * 3)
    assert tuple(tm.embedding.linear.shape) == (tfs.total_vocab, 1)
    tm, _, _ = _port("dcn_v2", jax_side)
    assert tuple(tm.cross.layer0.w.shape) == (6 * 4 + 4, 6 * 4 + 4)
    tm, _, _ = _port("dcn_v1", jax_side)
    assert tuple(tm.cross.layer0.w.shape) == (6 * 4 + 4, 1)


def test_new_weights_start_at_their_reference_scales():
    tfs, _ = make_criteo_like(n_dense=2, **DATA)
    g = torch.Generator().manual_seed(3)
    fwfm = get_model("fwfm", tfs, device="cpu", generator=g)
    ffm = get_model("ffm", tfs, device="cpu", generator=g)
    with torch.no_grad():
        assert float(fwfm.field_r.std()) == pytest.approx(0.1, rel=0.4)
        assert float(ffm.ffm.std()) == pytest.approx(0.05, rel=0.1)
        assert float(ffm.bias) == 0.0 and float(fwfm.bias) == 0.0


def test_fnn_warm_start_from_fm():
    """``fnn_from_fm`` copies FM's store into FNN, as the JAX warm start
    (tests/test_models_interaction.py::test_fnn_warm_start_from_fm) does:
    the same tables, and FNN's logits from them those of the JAX FNN."""
    fs, data, tfs, tdata = _data(4)
    jfm, jfnn = jax_get_model("fm", fs), jax_get_model("fnn", fs, hidden=(16, 8))
    fm_params, _ = jfm.init(jax.random.PRNGKey(1))
    fnn_params, state = jfnn.init(jax.random.PRNGKey(2))
    warm = jax_fnn_from_fm(fnn_params, fm_params)
    want, _, _ = jfnn.apply(warm, state, {"dense": data["dense"], "sparse": data["sparse"]})

    fm = get_model("fm", tfs, device="cpu")
    fnn = get_model("fnn", tfs, device="cpu", hidden=(16, 8))
    params_from_numpy(fm, _np_tree(fm_params))
    params_from_numpy(fnn, _np_tree(fnn_params))
    assert fnn_from_fm(fnn, fm) is fnn
    for k in ("table", "linear"):
        got = getattr(fnn.embedding, k)
        assert torch.equal(got, getattr(fm.embedding, k))
        assert got.data_ptr() != getattr(fm.embedding, k).data_ptr()   # a copy
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(fm_params["embedding"][k]))
    with torch.no_grad():
        got, _, _ = fnn({"dense": tdata["dense"], "sparse": tdata["sparse"]})
    _close(got.numpy(), want, 1e-5)


def _ops_input(which):
    """Field embeddings (B 32, F 6, D 4), a cross-net input (32, 28) or the
    embeddings' pair products, from one seed."""
    rng = np.random.default_rng(6)
    e = rng.normal(0, 1, (32, 6, 4)).astype(np.float32)
    if which == "x0":
        return rng.normal(0, 1, (32, 28)).astype(np.float32)
    return np.asarray(jinteractions.pairwise_products(e)) if which == "pairs" else e


def _probe(shape):
    return np.random.default_rng(7).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("op", ["fm_interaction_vector", "pairwise_products",
                                "pairwise_inner_products"])
def test_pair_ops_match_jax(op):
    """The op's output at rtol 1e-5, and its input's gradient of a fixed
    random functional of it at the gradient bar."""
    x = _ops_input("e")
    jfn, tfn = getattr(jinteractions, op), getattr(tinteractions, op)
    want = np.asarray(jfn(jnp.asarray(x)))
    probe = _probe(want.shape)
    xt = torch.tensor(x, requires_grad=True)
    got = tfn(xt)
    _close(got.detach().numpy(), want, 1e-5)
    (got * torch.from_numpy(probe)).sum().backward()
    _grad_close(xt.grad.numpy(),
                jax.grad(lambda a: jnp.sum(jfn(a) * probe))(jnp.asarray(x)))


@pytest.mark.parametrize("block,args,which", [
    ("OuterProduct", (4, 16), "e"), ("CrossNet", (28, 3), "x0"),
    ("CrossNetMix", (28, 2), "x0"), ("AFMAttention", (4, 8), "pairs")])
def test_interaction_blocks_match_jax(block, args, which):
    """Each block with the JAX block's parameters: the output at rtol 1e-5,
    and the gradients of a fixed random functional of it (its input's and
    every parameter's) at the gradient bar."""
    jblock = getattr(jinteractions, block)(*args)
    tblock = getattr(tinteractions, block)(*args)
    params = _np_tree(jblock.init(jax.random.PRNGKey(4)))
    params_from_numpy(tblock, params)
    x = _ops_input(which)
    want = np.asarray(jblock(params, jnp.asarray(x)))
    probe = _probe(want.shape)
    xt = torch.tensor(x, requires_grad=True)
    got = tblock(xt)
    _close(got.detach().numpy(), want, 1e-5)
    (got * torch.from_numpy(probe)).sum().backward()
    gx, gp = jax.grad(lambda a, p: jnp.sum(jblock(p, a) * probe),
                      argnums=(0, 1))(jnp.asarray(x), params)
    _grad_close(xt.grad.numpy(), gx)
    for pname, p in tblock.named_parameters():
        ref = gp
        for k in pname.split("."):
            ref = ref[k]
        _grad_close(p.grad.numpy(), ref)


@pytest.mark.parametrize("shape", [(32, 6), (5,)])
def test_gather_rows_matches_jax(shape):
    """``gather_rows`` of the port against the JAX one: the same rows, and
    the same (V, W) table gradient of a random functional of them."""
    rng = np.random.default_rng(8)
    table = rng.normal(0, 1, (40, 12)).astype(np.float32)
    ids = rng.integers(0, 40, shape).astype(np.int32)
    probe = rng.normal(0, 1, shape + (12,)).astype(np.float32)
    want = jembedding.gather_rows(jnp.asarray(table), jnp.asarray(ids), tape_key="ffm")
    gw = jax.grad(lambda t: jnp.sum(jembedding.gather_rows(t, jnp.asarray(ids)) * probe))(
        jnp.asarray(table))
    tt = torch.tensor(table, requires_grad=True)
    got = tembedding.gather_rows(tt, torch.from_numpy(ids).long(), tape_key="ffm")
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    (got * torch.from_numpy(probe)).sum().backward()
    _close(tt.grad.numpy(), gw, 1e-5)
