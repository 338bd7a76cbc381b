"""The extended interaction family: CCPM, FGCNN, FLEN, ONN, FAT-DeepFFM,
FiGNN, MLR and OENN, the port (ml_function_tpu_torch) against the JAX
package on the CPU, at 6 sparse fields of 50 ids, 4 dense, dim 4, B 64,
with the JAX weights carried across by the bridge.

Bars: with ``ML_FUNCTION_TPU_F32_MATMUL=1`` logits, aux terms and the total
loss within 1e-6 (relative to the largest) and every parameter's step-1
gradient within 1e-6·max|g| + 1e-6·|g|, max|g| over the parameter's
top-level block (FiGNN's ``score.b`` is a sum over B·F nodes whose terms
cancel: its f32 rounding, 5e-8, is 2e-6 of itself and 1e-7 of ``score``'s
max|g|); on the bf16 path 1e-4 and one bf16
step of max|g| (2^-8), or bf16 neighbours where both gradients are bf16
values (``ROADMAP.md`` R3), as ``tests/test_torch_sequence_tier.py`` holds
them. FiGNN also runs under ``ML_FUNCTION_TPU_FIELD_ATTN=1``: the port's
field-attention plain versions against the JAX package's Pallas kernels in
interpret mode, one call a forward.

MLR never reads its embedding's ``linear`` table nor its ``dense_linear``
unit (``ROADMAP.md`` R6): exactly zero gradient in JAX, none in the port.
"""

import contextlib
import os
import time

import jax
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.models.interaction_ext import _p_max_pool as jax_p_max_pool
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.models.interaction_ext import _p_max_pool
from ml_function_tpu_torch.ops import attention as tattention
from ml_function_tpu_torch.serving import export_model, load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

DATA_KW = dict(n_rows=64, n_dense=4, n_sparse=6, vocab_size=50, embed_dim=4, seed=3)
MODELS = {
    # even widths: JAX's SAME padding puts the odd cell after the input
    "ccpm": {"channels": (3, 2), "widths": (4, 3), "hidden": (16, 8)},
    "fgcnn": {"channels": (3, 4), "kernel_heights": (3, 2), "pool_sizes": (2, 2),
              "new_maps": (2, 2), "hidden": (16, 8)},
    "flen": {"hidden": (16, 8)},
    "onn": {"ffm_dim": 3, "hidden": (16, 8)},
    "fat_deepffm": {"ffm_dim": 3, "hidden": (16, 8)},
    "fignn": {"steps": 2},
    "mlr": {"regions": 3},
    "oenn": {"max_order": 3, "hidden": (16, 8)},
}
# (model, f32 matmuls, field-attention flag)
CASES = ([(m, f32, False) for m in MODELS for f32 in (True, False)]
         + [("fignn", f32, True) for f32 in (True, False)])
UNREAD = {"mlr": {"embedding.linear", "dense_linear.dense.w", "dense_linear.dense.b"}}
F32_BAR = 1e-6
# MLR's logit log p − log(1 − p) at p ≈ 1/2 is a difference of two logs of
# about 0.7, each rounded in f32, so its rounding is about 1e-7 absolute
# against logits of about 0.2: its logits and loss are held at 1e-5
F32_FWD_BAR = {"mlr": 1e-5}


def _ids(cases):
    return [f"{m}-{'f32' if f else 'bf16'}{'-flag' if flag else ''}"
            for m, f, flag in cases]


@contextlib.contextmanager
def _env(f32: bool, flag: bool):
    """Both packages' switches, read at call (trace) time by both."""
    saved = {k: os.environ.get(k) for k in ("ML_FUNCTION_TPU_F32_MATMUL",
                                            "ML_FUNCTION_TPU_FIELD_ATTN")}
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1" if f32 else "0"
    os.environ["ML_FUNCTION_TPU_FIELD_ATTN"] = "1" if flag else "0"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _weight():
    w = np.ones(DATA_KW["n_rows"], np.float32)
    w[-5:] = 0.0
    return w


def _flat(tree):
    return {".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the JAX model's parameters, logits, aux terms, total loss
    and gradients (one jitted value_and_grad each), and the JAX side's
    seconds."""
    t = time.perf_counter()
    fs, data = jax_make(**DATA_KW)
    data = dict(data, weight=_weight())
    out = {}
    for name, f32, flag in CASES:
        with _env(f32, flag):
            jm = jax_get_model(name, fs, **MODELS[name])
            params, state = jm.init(jax.random.PRNGKey(0))
            fn = jax.jit(jax.value_and_grad(
                lambda p: jloop.loss_fn(jm, p, state, data, None), has_aux=True))
            (total, (logits, _, aux, _)), grads = fn(params)
        out[name, f32, flag] = dict(
            params=jax.tree_util.tree_map(np.asarray, params),
            logits=np.asarray(logits), aux={k: float(v) for k, v in aux.items()},
            total=float(total), grads=_flat(grads))
    out["seconds"] = time.perf_counter() - t
    return out


def _port_batch():
    fs, data = make_criteo_like(**DATA_KW)
    return fs, dict(data, weight=_weight())


def _port_model(name, params):
    fs, _ = _port_batch()
    tm = get_model(name, fs, device="cpu", **MODELS[name])
    params_from_numpy(tm, params)
    return tm


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bf16(x):
    return torch.tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _grad_close_bf16(got, want, scale, what):
    """Within one bf16 step of the largest, 2^-8·scale (+ 1e-3·|want|), or
    neighbouring bf16 values where both tensors are bf16 values (R3)."""
    err = np.abs(got - want)
    ok = err <= 2.0 ** -8 * scale + 1e-3 * np.abs(want)
    if np.array_equal(_bf16(got), got) and np.array_equal(_bf16(want), want):
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        ok |= err <= np.ldexp(1.0, e - 8)
    assert ok.all(), f"{what}: max |err| {err.max()} (scale {scale})"


@pytest.mark.parametrize("name,f32,flag", CASES, ids=_ids(CASES))
def test_loss_and_gradients_match_jax(jax_side, name, f32, flag, monkeypatch):
    """Logits, aux terms and the total loss of one batch, and the gradient
    of every parameter; with the flag FiGNN's attention takes the
    field-attention route (once a forward) in both packages."""
    side = jax_side[name, f32, flag]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", "1" if flag else "0")
    calls = []
    real = tattention.field_attention
    monkeypatch.setattr(tattention, "field_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    fwd_bar = F32_FWD_BAR.get(name, F32_BAR) if f32 else 1e-4
    tm = _port_model(name, side["params"])
    _, tdata = _port_batch()
    total, (logits, _, aux, _) = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    assert calls == ([(64, 6, 2, 2)] if flag else [])
    assert set(aux) == set(side["aux"])
    _close(logits.detach().numpy(), side["logits"], fwd_bar)
    for k, v in aux.items():
        _close(v.item(), side["aux"][k], fwd_bar)
    _close(total.item(), side["total"], fwd_bar)
    grads = side["grads"]
    assert {n for n, _ in tm.named_parameters()} == set(grads)
    unread = UNREAD.get(name, set())
    block_max = {}
    for n in set(grads) - unread:
        top = n.split(".")[0]
        block_max[top] = max(block_max.get(top, 0.0), float(np.abs(grads[n]).max()))
    for pname, p in tm.named_parameters():
        want = grads[pname]
        if pname in unread:
            assert p.grad is None and not want.any(), pname
            continue
        scale = block_max[pname.split(".")[0]] if f32 else float(np.abs(want).max())
        if f32:
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=F32_BAR,
                                       atol=F32_BAR * scale, err_msg=pname)
        else:
            _grad_close_bf16(p.grad.numpy(), want, scale, pname)


def test_jax_side_takes_seconds(jax_side):
    """The JAX side of every case, compiled and run once for the module,
    takes tens of seconds (about 30 alone); the bar leaves room for a
    loaded machine and catches a compile that runs away."""
    assert jax_side["seconds"] < 300, jax_side["seconds"]


def test_fignn_export_scores_in_the_port(jax_side, tmp_path):
    """FiGNN through ``export_model`` → ``load_scorer(device='cpu')``, its
    steps a hyperparameter: the scores are the JAX model's."""
    side = jax_side["fignn", True, False]
    tm = _port_model("fignn", side["params"])
    fs, tdata = _port_batch()
    path = export_model(str(tmp_path / "m"), "fignn", fs, tm, hyperparams={"steps": 2})
    scorer = load_scorer(path, batch_size=24, device="cpu")
    with _env(True, False):
        got = scorer.predict_proba({k: tdata[k] for k in ("dense", "sparse")})
    want = 1.0 / (1.0 + np.exp(-side["logits"].astype(np.float64)))
    assert scorer.model.name == "FiGNN" and got.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_p_max_pool_matches_jax_with_ties():
    """Each channel's top k in their original order; among equal values the
    lower index first, as ``lax.top_k`` picks them."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, size=(5, 9, 3)).astype(np.float32)   # many ties
    for k in (1, 3, 9):
        want = np.asarray(jax_p_max_pool(x, k))
        got = _p_max_pool(torch.from_numpy(x), k).numpy()
        np.testing.assert_array_equal(got, want)


def test_new_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    fs, _ = _port_batch()
    for name in MODELS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(name, fs)


def test_oenn_rejects_an_order_past_three():
    fs, _ = _port_batch()
    with pytest.raises(ValueError, match="max_order"):
        get_model("oenn", fs, device="cpu", max_order=4)


def test_new_weights_start_at_their_reference_scales():
    """The tables and kernels that the models own draw from the reference's
    initializers: normal(0.05) field-aware and order tables, glorot
    convolutions and message weights."""
    fs, _ = _port_batch()
    g = torch.Generator().manual_seed(0)
    onn = get_model("onn", fs, device="cpu", generator=g)
    oenn = get_model("oenn", fs, device="cpu", generator=g)
    ccpm = get_model("ccpm", fs, device="cpu", generator=g)
    fignn = get_model("fignn", fs, device="cpu", generator=g)
    assert onn.ffm.shape == (fs.total_vocab, 6 * 4)
    for t in (onn.ffm, oenn.order2, oenn.order3):
        assert float(t.detach().std()) == pytest.approx(0.05, rel=0.2)
    limit = np.sqrt(6.0 / (4 + 4))                  # conv0 (3, 4, 4): fan_in 4, fan_out 4
    assert ccpm.conv0.shape == (3, 4, 4)
    assert 0.5 * limit < float(ccpm.conv0.detach().abs().max()) <= limit
    assert 0.5 * limit < float(fignn.wmsg.detach().abs().max()) <= limit   # (4, 4)
