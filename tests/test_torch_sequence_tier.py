"""The behavior-sequence tier: BST, DSIN, SeqFM, DSTN, DMIN and MIND, and the
ops they bring (LSTM, BiLSTM, TransformerBlock, SessionPositionBias,
sincos_position_encoding, sessionize, make_interest_drift_data): the port
(ml_function_tpu_torch) against the JAX package on the CPU, at 2 behavior
sequences, dim 4, L 8, sessions (2, 4), B 32, with the JAX weights carried
across by the bridge. Row 3 of the batch has no behavior at all, so each
model's fully padded history (DSIN's and DMIN's ``safe_mask``) is taken.

Bars, those of tests/test_torch_sequence.py: with
``ML_FUNCTION_TPU_F32_MATMUL=1`` logits and losses within 1e-5 and
gradients within 1e-4·max|g|; on the bf16 path 1e-4 and 1e-3 (``ROADMAP.md``
R3). The max|g| is the tensor's own, except in a target attention's MLP
(``attn*``), where it is the block's: the softmax over steps does not see a
shift of every score, so its head bias's gradient is zero up to rounding.
On the bf16 path an f32 value that lies an ulp from a bf16 rounding
midpoint rounds to neighbouring bf16 values in the two packages, whose f32
sums differ in order (R3). DMIN's tower input at row 28 lies 1 ulp from
one, which moves that row's logit by 1.7e-3: so at most 1% of the logits
(at least one) may pass 1e-4, each within one bf16 step (2^-8) of the
largest, while a rounding site that one package lacked would move every
row. A step in a bf16 input cotangent flows on, summed, into the
gradients below it: BST's reach 5.8e-3 of their max|g| (``block0.mha.k``,
where both packages' gradients are bf16 values one step apart) and
2.8e-3 in its f32-valued LayerNorm and bias gradients. So on the bf16
path the gradients are held at chip_smoke.py's bf16-path bar, one bf16
step of max|g| (2^-8), with two bf16 neighbours agreeing, as
``parity_steps`` there holds them.

With ``ML_FUNCTION_TPU_FIELD_ATTN=1`` the self-attention of DSIN's sessions,
DMIN's refiner, SeqFM's static view and BST's blocks (L + 1 = 9 here) takes
the field-attention route in both packages: the port's plain versions
against the JAX package's Pallas kernels in interpret mode.

The parameters that the reference creates and never reads (``ROADMAP.md``
R6: DMIN's ``extractor.o`` and ``extractor.ln``, MIND's ``b0``, frozen by
``stop_gradient``) have exactly zero gradient in JAX and none in the port.
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.features.encoders import sessionize as jax_sessionize
from ml_function_tpu.features.synthetic import make_behavior_data as jax_make
from ml_function_tpu.features.synthetic import \
    make_interest_drift_data as jax_drift
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops.attention import SessionPositionBias as JBias
from ml_function_tpu.ops.attention import TransformerBlock as JBlock
from ml_function_tpu.ops.attention import \
    sincos_position_encoding as jax_sincos
from ml_function_tpu.ops.recurrent import LSTM as JLSTM
from ml_function_tpu.ops.recurrent import BiLSTM as JBiLSTM
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.encoders import sessionize
from ml_function_tpu_torch.features.synthetic import (make_behavior_data,
                                                      make_interest_drift_data)
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import attention as tattention
from ml_function_tpu_torch.ops.attention import (SessionPositionBias,
                                                 TransformerBlock,
                                                 sincos_position_encoding)
from ml_function_tpu_torch.ops.recurrent import LSTM, BiLSTM
from ml_function_tpu_torch.serving import export_model, load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

DATA_KW = dict(n_rows=32, n_items=30, n_cates=6, seq_len=8, embed_dim=4, seed=2,
               session_shape=(2, 4))
EMPTY_ROW = 3
MODELS = {"bst": {"hidden": (16, 8)}, "dsin": {"hidden": (16, 8)},
          "seqfm": {"ffn_hidden": (8,)}, "dstn": {"hidden": (16, 8)},
          "dmin": {"hidden": (16, 8)}, "mind": {"hidden": (16, 8)}}
FLAG_MODELS = ("dsin", "dmin", "seqfm", "bst")
# (model, f32 matmuls, field-attention flag)
CASES = ([(m, f32, False) for m in MODELS for f32 in (True, False)]
         + [(m, True, True) for m in FLAG_MODELS])
# the parameters the reference never reads, or freezes (R6)
UNREAD = {"dmin": {"extractor.o", "extractor.ln.scale", "extractor.ln.bias"},
          "mind": {"b0"}}


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


def _empty_history(data):
    """Row EMPTY_ROW with no behavior in any sequence."""
    for k in data["seq"]:
        data["seq"][k][EMPTY_ROW] = 0
    return data


def _weight():
    w = np.ones(DATA_KW["n_rows"], np.float32)
    w[-5:] = 0.0
    return w


def _jax_batch():
    fs, data = jax_make(**DATA_KW)
    return fs, dict(_empty_history(data), weight=_weight())


def _port_batch():
    fs, data = make_behavior_data(**DATA_KW)
    return fs, dict(_empty_history(data), weight=_weight())


def _flat(tree):
    return {".".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the JAX model's parameters, logits, aux terms, total loss
    and gradients (one jitted value_and_grad each)."""
    fs, data = _jax_batch()
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
    with _env(True, False):
        jm = jax_get_model("mind", fs, **MODELS["mind"])
        side = out["mind", True, False]
        out["mind_interests"] = np.asarray(jm.interests(side["params"], data))
    return out


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _close_bf16(got, want, rtol, scale, what=""):
    """The bf16 path's logits: every element within rtol·scale + rtol·|want|,
    but for at most 1% of them (at least one), each within 2^-8·scale."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    off = err > rtol * scale + rtol * np.abs(want)
    assert off.sum() <= max(1, off.size // 100), \
        f"{what}: {off.sum()} of {off.size} elements past the bar, max |err| {err.max()}"
    assert (err[off] <= 2.0 ** -8 * scale).all(), f"{what}: max |err| {err.max()}"


def _bf16(x):
    return torch.tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _grad_close_bf16(got, want, scale, what):
    """The bf16 path's gradients: within one bf16 step of the largest,
    2^-8·scale (+ 1e-3·|want|), or neighbouring bf16 values where both
    tensors are bf16 values (R3: a weight gradient through ``bf16_matmul``
    is rounded to bf16)."""
    err = np.abs(got - want)
    ok = err <= 2.0 ** -8 * scale + 1e-3 * np.abs(want)
    if np.array_equal(_bf16(got), got) and np.array_equal(_bf16(want), want):
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        ok |= err <= np.ldexp(1.0, e - 8)
    assert ok.all(), f"{what}: max |err| {err.max()} (scale {scale})"


def _port_model(name, params):
    fs, _ = _port_batch()
    tm = get_model(name, fs, device="cpu", **MODELS[name])
    params_from_numpy(tm, params)
    return tm


@pytest.mark.parametrize("name,f32,flag", CASES, ids=_ids(CASES))
def test_loss_and_gradients_match_jax(jax_side, name, f32, flag, monkeypatch):
    """Logits, the aux terms and the total loss of one batch, and the
    gradient of every parameter; with the flag, the field-attention route
    is taken (once a forward: one attention layer a model at this size)."""
    side = jax_side[name, f32, flag]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", "1" if flag else "0")
    calls = []
    real = tattention.field_attention
    monkeypatch.setattr(tattention, "field_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    fwd_bar = 1e-5 if f32 else 1e-4
    tm = _port_model(name, side["params"])
    _, tdata = _port_batch()
    total, (logits, _, aux, _) = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    assert len(calls) == (1 if flag else 0)
    assert set(aux) == set(side["aux"])
    if f32:
        _close(logits.detach(), side["logits"], fwd_bar)
    else:
        _close_bf16(logits.detach(), side["logits"], fwd_bar,
                    float(np.abs(side["logits"]).max()), "logits")
    for k, v in aux.items():
        _close(v.item(), side["aux"][k], fwd_bar)
    _close(total.item(), side["total"], fwd_bar)
    grads = side["grads"]
    names = {n for n, _ in tm.named_parameters()}
    assert names == set(grads)
    unread = UNREAD.get(name, set())
    block_max = {}
    for n in names - unread:
        if n.startswith("attn"):
            top = n.split(".")[0]
            block_max[top] = max(block_max.get(top, 0.0), float(np.abs(grads[n]).max()))
    for pname, p in tm.named_parameters():
        want = grads[pname]
        if pname in unread:
            assert p.grad is None and not want.any(), pname
            continue
        scale = block_max.get(pname.split(".")[0], float(np.abs(want).max()))
        if f32:
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=pname)
        else:
            _grad_close_bf16(p.grad.numpy(), want, scale, pname)


def test_mind_interests_match_jax(jax_side):
    tm = _port_model("mind", jax_side["mind", True, False]["params"])
    _, tdata = _port_batch()
    with _env(True, False), torch.no_grad():
        got = tm.interests(tdata)
    assert got.shape == (DATA_KW["n_rows"], 4, 8)
    _close(got.numpy(), jax_side["mind_interests"], 1e-5)


def test_mind_b0_stays_as_drawn_under_adam(jax_side):
    """b0 gets no gradient, so the optimizer leaves it where it was, as
    optax does with the JAX package's zero gradient."""
    from ml_function_tpu_torch.train.loop import make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer

    tm = _port_model("mind", jax_side["mind", True, False]["params"])
    b0 = tm.b0.detach().clone()
    table = tm.embedding.table.detach().clone()
    _, tdata = _port_batch()
    step = make_train_step(tm, make_optimizer("adam", 1e-2).init(tm))
    for _ in range(2):
        step(tdata)
    assert torch.equal(tm.b0, b0) and not torch.equal(tm.embedding.table, table)


def test_dmin_multi_interest_heads_differ():
    """The K interest channels give distinct interest vectors, each pooled
    by its own target attention (``attn0`` … ``attn{K-1}``)."""
    fs, data = _port_batch()
    tm = get_model("dmin", fs, device="cpu", hidden=(16, 8), num_interests=3,
                   generator=torch.Generator().manual_seed(0))
    pooled = {}
    hooks = [getattr(tm, f"attn{k}").register_forward_hook(
        lambda mod, inp, out, k=k: pooled.__setitem__(k, out)) for k in range(3)]
    with torch.no_grad():
        logits, _, aux = tm(data, train=True)
    for h in hooks:
        h.remove()
    assert logits.shape == (32,) and float(aux["aux_loss"]) > 0
    assert sorted(pooled) == [0, 1, 2]
    for a in range(3):
        for b in range(a + 1, 3):
            assert (pooled[a] - pooled[b]).abs().max() > 1e-3


def test_dsin_export_scores_in_the_port(jax_side, tmp_path):
    """DSIN through ``export_model`` → ``load_scorer(device='cpu')``, its
    session shape a hyperparameter: the scores are the JAX model's."""
    side = jax_side["dsin", True, False]
    tm = _port_model("dsin", side["params"])
    fs, tdata = _port_batch()
    path = export_model(str(tmp_path / "m"), "dsin", fs, tm,
                        hyperparams={"hidden": [16, 8], "session_shape": [2, 4]})
    scorer = load_scorer(path, batch_size=12, device="cpu")
    with _env(True, False):
        got = scorer.predict_proba({k: tdata[k] for k in ("dense", "sparse", "seq")})
    want = 1.0 / (1.0 + np.exp(-side["logits"].astype(np.float64)))
    assert got.shape == (32,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sequence_tier_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    fs, _ = _port_batch()
    for name in MODELS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(name, fs)


def test_dsin_session_shape_must_cover_the_history():
    fs, _ = _port_batch()
    with pytest.raises(ValueError, match="session shape 3x4"):
        get_model("dsin", fs, device="cpu", session_shape=(3, 4))


def test_bst_takes_a_shorter_history_as_jax_does(jax_side):
    """BST's position encodings are a buffer of the spec's length + 1: a
    history cut to 5 of its 8 positions takes the first 6 rows and scores
    as the reference, which computes them at the batch's length (f32
    matmuls, the parity test's 1e-5); a history past the spec's raises."""
    side = jax_side["bst", True, False]
    jfs, jdata = _jax_batch()
    _, tdata = _port_batch()
    cut = lambda d: {**d, "seq": {k: v[:, :5] for k, v in d["seq"].items()}}
    with _env(True, False):
        jm = jax_get_model("bst", jfs, **MODELS["bst"])
        want, _, _ = jm.apply(side["params"], {}, cut(jdata))
        tm = _port_model("bst", side["params"])
        with torch.no_grad():
            got, _, _ = tm(tloop.to_device(cut(tdata), "cpu"))
            _close(got, want, 1e-5)
            longer = {**tdata, "seq": {k: np.concatenate([v, v], 1)
                                       for k, v in tdata["seq"].items()}}
            with pytest.raises(ValueError, match="past the spec's max_len 8"):
                tm(tloop.to_device(longer, "cpu"))


# ---- ops ------------------------------------------------------------------


def _lstm_inputs(b=6, l=7, d=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    mask = rng.uniform(size=(b, l)) > 0.3
    mask[1] = False                  # a fully masked row holds its zero state
    mask[2, :4] = False              # a row that starts late
    return x, mask


def _jax_tree_grads(fn, params, *args):
    return jax.tree_util.tree_map(np.asarray, jax.grad(fn)(params, *args))


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_matches_jax(reverse, monkeypatch):
    """LSTM forward and reverse: the sequence, the last state and the
    gradients of sum(sin(seq)) to the input and every parameter, with
    ragged masks and a fully masked row (its states stay 0)."""
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    x, mask = _lstm_inputs()
    jcell = JLSTM(5, 3)
    params = jax.tree_util.tree_map(np.asarray, jcell.init(jax.random.PRNGKey(4)))
    seq, last = jcell(params, jnp.asarray(x), jnp.asarray(mask), reverse=reverse)
    jg = _jax_tree_grads(lambda p, xx: jnp.sum(jnp.sin(
        jcell(p, xx, jnp.asarray(mask), reverse=reverse)[0])), params, jnp.asarray(x))
    jgx = np.asarray(jax.grad(lambda xx: jnp.sum(jnp.sin(
        jcell(params, xx, jnp.asarray(mask), reverse=reverse)[0])))(jnp.asarray(x)))

    cell = LSTM(5, 3)
    params_from_numpy(cell, params)
    tx = torch.from_numpy(x).requires_grad_()
    tseq, tlast = cell(tx, torch.from_numpy(mask), reverse=reverse)
    _close(tseq.detach().numpy(), seq, 1e-5)
    _close(tlast.detach().numpy(), last, 1e-5)
    assert not tseq[1].any()
    torch.sin(tseq).sum().backward()
    _close(tx.grad.numpy(), jgx, 1e-5)
    for n, p in cell.named_parameters():
        _close(p.grad.numpy(), jg[n], 1e-5)


def test_bilstm_matches_jax():
    """BiLSTM on the bf16 path (both packages round the products' inputs):
    the concatenated sequence and the gradients of its sum of sines."""
    x, mask = _lstm_inputs(seed=1)
    jm = JBiLSTM(5, 4)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    with _env(False, False):
        want = np.asarray(jm(params, jnp.asarray(x), jnp.asarray(mask)))
        jg = _jax_tree_grads(lambda p: jnp.sum(jnp.sin(
            jm(p, jnp.asarray(x), jnp.asarray(mask)))), params)
        m = BiLSTM(5, 4)
        params_from_numpy(m, params)
        got = m(torch.from_numpy(x), torch.from_numpy(mask))
        torch.sin(got).sum().backward()
    assert got.shape == (6, 7, 8)
    _close(got.detach().numpy(), want, 1e-4)
    for n, p in m.named_parameters():
        top, rest = n.split(".", 1)
        _close(p.grad.numpy(), jg[top][rest], 1e-3)


@pytest.mark.parametrize("flag", [False, True])
def test_transformer_block_matches_jax(flag):
    """A causal-free block over a masked sequence, and its gradients; with
    the flag the attention takes the field-attention route in both."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(5, 9, 8)).astype(np.float32)
    mask = rng.uniform(size=(5, 9)) > 0.3
    mask[:, -1] = True
    jb = JBlock(8, 2, ffn_hidden=(16,))
    params = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(7)))
    with _env(True, flag):
        want = np.asarray(jb(params, jnp.asarray(x), jnp.asarray(mask)))
        jg = _flat(jax.grad(lambda p: jnp.sum(jnp.sin(
            jb(p, jnp.asarray(x), jnp.asarray(mask)))))(params))
        tb = TransformerBlock(8, 2, ffn_hidden=(16,))
        params_from_numpy(tb, params)
        got = tb(torch.from_numpy(x), mask=torch.from_numpy(mask))
        torch.sin(got).sum().backward()
    _close(got.detach().numpy(), want, 1e-5)
    for n, p in tb.named_parameters():
        _close(p.grad.numpy(), jg[n], 1e-4)


def test_session_position_bias_and_sincos_match_jax():
    jb = JBias(3, 4, 6)
    params = jax.tree_util.tree_map(np.asarray, jb.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(8)
    params = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=(2, 3, 4, 6)).astype(np.float32)
    m = SessionPositionBias(3, 4, 6)
    assert {n: tuple(p.shape) for n, p in m.named_parameters()} == {
        "sess": (3, 1, 1), "pos": (1, 4, 1), "unit": (1, 1, 6)}
    assert not any(p.any() for p in m.parameters())
    params_from_numpy(m, params)
    np.testing.assert_array_equal(m(torch.from_numpy(x)).detach().numpy(),
                                  np.asarray(jb(params, jnp.asarray(x))))
    for length, dim in ((65, 16), (9, 8), (5, 7)):
        got = sincos_position_encoding(length, dim)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_sincos(length, dim)))


def test_sessionize_and_data_generators_are_the_reference():
    rng = np.random.default_rng(9)
    seq = rng.integers(0, 50, (7, 10)).astype(np.int32)
    for shape in ((2, 4), (3, 4), (2, 5)):
        got = sessionize(seq, *shape)
        assert got.dtype == seq.dtype
        np.testing.assert_array_equal(got, jax_sessionize(seq, *shape))
    kw = dict(n_rows=120, n_items=20, seq_len=10, embed_dim=4, noise=0.2, seed=3)
    fs, data = make_interest_drift_data(**kw)
    jfs, jdata = jax_drift(**kw)
    assert dataclasses.asdict(fs) == dataclasses.asdict(jfs)
    for k in ("dense", "sparse", "label"):
        assert data[k].dtype == jdata[k].dtype
        np.testing.assert_array_equal(data[k], jdata[k])
    np.testing.assert_array_equal(data["seq"]["hist_item"], jdata["seq"]["hist_item"])
