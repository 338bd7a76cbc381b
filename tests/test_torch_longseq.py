"""SIM: the port (ml_function_tpu_torch) against the JAX package on the CPU,
with the JAX weights carried across by the bridge.

Data: ``make_behavior_data(n_rows=64, n_items=40, n_cates=8, seq_len=8,
embed_dim=4)`` plus ``hist_long``, a lifelong stream of 512 item ids
(lengths 256 to 512, right-padded with 0), batches of the first 8 rows
with the last 2 weighted 0. The stream is one field of width 4 against a
short behavior of width 8, so both models carry ``align_long``. Soft search
scores the stream and keeps the top 8 before the exact search unit; hard
search hands it the stream as ``hard_search`` filtered it (the items of the
candidate's category, under a category map drawn from a seed), at its full
512 steps, so the ESU's ``MultiHeadAttention('auto')`` takes the flash
route in both packages (the port's plain versions, the JAX kernels in
interpret mode).

Routes: the DIEN core on the scan route (the reference's default), with
and without bf16, and on the kernel route, where the port sets
``kernel = 'pallas'`` on ``dien.gru1`` and ``dien.gru2`` and the JAX SIM's
DIEN is built with ``GRU(kd, kd, kernel='pallas')`` (the names ``GRU`` and
``AUGRU`` of ``ml_function_tpu.models.sequence`` patched; no file
changes), with the merge-scatter gradient K1 on.

Bars, as for DIEN (tests/test_torch_sequence.py): with
``ML_FUNCTION_TPU_F32_MATMUL=1`` logits, ``aux_loss``, ``emb_l2`` and the
loss within 1e-5 and gradients within 1e-4·max|g|; on the bf16 path 1e-4
and 1e-3 (``ROADMAP.md`` R3). The max|g| is the tensor's own, except in the
two target attentions (``attn`` and ``dien.attn``), where it is the
block's: their softmax over steps does not see a shift of every score, so
the gradient of the MLP's head bias is zero up to rounding. DIEN's own
tower (``dien.mlp``) is unused by SIM: no gradient in the port, zeros in
JAX.
"""

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_function_tpu.models.sequence as jseq
import ml_function_tpu.ops.embedding as jemb
from ml_function_tpu.features.encoders import hard_search as jax_hard_search
from ml_function_tpu.features.schema import SeqSpec as JSeqSpec
from ml_function_tpu.features.synthetic import make_behavior_data as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops.recurrent import GRU as JGRU
from ml_function_tpu.serving import Scorer as JaxScorer
from ml_function_tpu.serving import export_model as jax_export
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.encoders import hard_search
from ml_function_tpu_torch.features.schema import SeqSpec
from ml_function_tpu_torch.features.synthetic import make_behavior_data
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.models.longseq import top_k_indices
from ml_function_tpu_torch.ops import attention as tattention
from ml_function_tpu_torch.ops import embedding as temb
from ml_function_tpu_torch.ops.kernels import embedding_grad as teg
from ml_function_tpu_torch.ops.kernels import flash_attention as tfl
from ml_function_tpu_torch.ops.kernels import gru as tgru
from ml_function_tpu_torch.serving import load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

DATA_KW = dict(n_rows=64, n_items=40, n_cates=8, seq_len=8, embed_dim=4, seed=0)
L_LONG, B = 512, 8
HP = {"hidden": (16, 8), "long_behavior": ("hist_long",)}
# (search, route, f32)
CASES = [(s, r, f) for s in ("soft", "hard") for r, f in
         (("scan", True), ("scan", False), ("kernel", True))]


def _ids(cases):
    return [f"{s}-{r}-{'f32' if f else 'bf16'}" for s, r, f in cases]


def _long_stream():
    """(64, 512) item ids, lengths 256..512, right-padded; and a category
    for each item id (0 for the pad id)."""
    rng = np.random.default_rng(1)
    lens = rng.integers(L_LONG // 2, L_LONG + 1, DATA_KW["n_rows"])
    ids = rng.integers(1, DATA_KW["n_items"] + 1, (DATA_KW["n_rows"], L_LONG))
    ids = (ids * (np.arange(L_LONG)[None, :] < lens[:, None])).astype(np.int32)
    cate = np.concatenate([[0], rng.integers(1, DATA_KW["n_cates"] + 1,
                                             DATA_KW["n_items"])]).astype(np.int32)
    return ids, cate


def _data(search: str, n: int = B):
    """The first n rows, with the stream (hard-searched for 'hard') and a
    weight mask whose last 2 entries are 0."""
    _, data = jax_make(**DATA_KW)
    ids, cate = _long_stream()
    if search == "hard":
        ids = hard_search(ids, cate[ids], data["sparse"][:, 1])
    data["seq"]["hist_long"] = ids
    out = {k: ({s: a[:n] for s, a in v.items()} if k == "seq" else v[:n])
           for k, v in data.items()}
    out["weight"] = np.ones(n, np.float32)
    out["weight"][-2:] = 0.0
    return out


def _long_spec(cls):
    return cls("hist_long", DATA_KW["n_items"] + 1, L_LONG, vocab_name="item",
               dim=DATA_KW["embed_dim"])


def _jax_fs():
    fs, _ = jax_make(**DATA_KW)
    return fs.replace(seq=fs.seq + (_long_spec(JSeqSpec),))


def _port_fs():
    fs, _ = make_behavior_data(**DATA_KW)
    return fs.replace(seq=fs.seq + (_long_spec(SeqSpec),))


@contextlib.contextmanager
def _jax_route(kernel: bool, f32: bool):
    """The JAX SIM's DIEN built with GRU(kernel='pallas') and the
    merge-scatter on (kernel), and the f32 matmul switch."""
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


def _jax_model(search):
    jm = jax_get_model("sim", _jax_fs(), search=search, **HP)
    params, state = jm.init(jax.random.PRNGKey(0))
    return jm, jax.tree_util.tree_map(np.asarray, params), state


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the JAX params, logits, aux terms, total loss and
    gradients of one batch (jitted: one compile a case costs a tenth of
    the scan's eager steps)."""
    out = {}
    for search, route, f32 in CASES:
        with _jax_route(route == "kernel", f32):
            jm, params, state = _jax_model(search)
            data = _data(search)
            (total, (logits, _, aux, _)), grads = jax.jit(jax.value_and_grad(
                lambda p: jloop.loss_fn(jm, p, state, data, None),
                has_aux=True))(params)
        out[search, route, f32] = (params, np.asarray(logits),
                                   {k: float(v) for k, v in aux.items()}, float(total),
                                   jax.tree_util.tree_map(np.asarray, grads))
    return out


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _at(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return tree


def _port_model(search, params, route):
    tm = get_model("sim", _port_fs(), device="cpu", search=search, **HP)
    params_from_numpy(tm, params)
    if route == "kernel":
        tm.dien.gru1.kernel = tm.dien.gru2.kernel = "pallas"
    return tm


def test_hard_search_is_the_reference():
    _, data = jax_make(**DATA_KW)
    ids, cate = _long_stream()
    got = hard_search(ids, cate[ids], data["sparse"][:, 1])
    want = jax_hard_search(ids, cate[ids], data["sparse"][:, 1:2])
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(hard_search(ids, cate[ids], data["sparse"][:, 1:2]), want)
    kept = (got != 0).sum(axis=1)
    assert 0 < kept.min() and kept.max() < (ids != 0).sum(axis=1).max()


@pytest.mark.parametrize("search,route,f32", CASES, ids=_ids(CASES))
def test_loss_and_gradients_match_jax(jax_side, search, route, f32, monkeypatch):
    """Logits, aux terms and the total loss of one batch, and the gradient
    of every parameter; the CPU runs the plain versions of every kernel and
    launches none. Hard search goes through flash attention (once forward,
    once backward), soft search does not (8 keys)."""
    params, want_logits, want_aux, want_total, want_grads = jax_side[search, route, f32]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    monkeypatch.setattr(temb, "_USE_MERGE_SCATTER", route == "kernel")
    fwd_bar, grad_bar = (1e-5, 1e-4) if f32 else (1e-4, 1e-3)
    tm = _port_model(search, params, route)
    flash_calls = []
    real = tattention.flash_attention
    monkeypatch.setattr(tattention, "flash_attention",
                        lambda *a, **kw: flash_calls.append(a[1].shape) or real(*a, **kw))
    tgru.gru_fwd_launches = tgru.gru_bwd_launches = teg.merge_scatter_launches = 0
    tfl.flash_fwd_launches = tfl.flash_bwd_dq_launches = tfl.flash_bwd_dkv_launches = 0
    total, (logits, _, aux, _) = tloop.loss_fn(tm, tloop.to_device(_data(search), "cpu"))
    total.backward()
    assert flash_calls == ([(B, 2, L_LONG, 4)] if search == "hard" else [])
    assert (tgru.gru_fwd_launches, tgru.gru_bwd_launches, teg.merge_scatter_launches,
            tfl.flash_fwd_launches, tfl.flash_bwd_dq_launches,
            tfl.flash_bwd_dkv_launches) == (0,) * 6
    assert set(aux) == set(want_aux) == {"aux_loss", "emb_l2"}
    _close(logits.detach(), want_logits, fwd_bar)
    for k, v in aux.items():
        _close(v.item(), want_aux[k], fwd_bar)
    _close(total.item(), want_total, fwd_bar)
    names = {n for n, _ in tm.named_parameters()}
    assert names == {".".join(str(k.key) for k in path) for path, _ in
                     jax.tree_util.tree_flatten_with_path(want_grads)[0]}
    block_max = {p: max(float(np.abs(_at(want_grads, n)).max()) for n in names
                        if n.startswith(p)) for p in ("attn.", "dien.attn.")}
    for pname, p in tm.named_parameters():
        want = _at(want_grads, pname)
        if pname.startswith("dien.mlp."):
            assert p.grad is None and not want.any(), pname
            continue
        scale = next((v for k, v in block_max.items() if pname.startswith(k)),
                     float(np.abs(want).max()))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=grad_bar,
                                   atol=grad_bar * scale, err_msg=pname)


def test_parameter_key_paths_are_the_reference_paths():
    jm, params, _ = _jax_model("hard")
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    tm = get_model("sim", _port_fs(), device="cpu", search="hard", **HP)
    got = {n.replace(".", "/"): tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    assert got["align_long/w"] == (4, 8) and got["mha/q"] == (8, 8)
    assert "align_long/w" not in {n.replace(".", "/") for n, _ in get_model(
        "sim", _port_fs(), device="cpu", hidden=(16, 8)).named_parameters()}


def test_top_k_picks_what_lax_top_k_picks():
    """Ties: a stream with repeated ids scores equal values, and its padded
    steps all score -inf; the port's choice and order are lax.top_k's."""
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 6, (4, 40))
    ids[:, 25:] = 0
    ids[3, 2:] = 0                          # fewer valid steps than k
    table = rng.normal(size=(6,)).astype(np.float32)
    scores = np.where(ids != 0, table[ids], -np.inf).astype(np.float32)
    for k in (1, 8, 30):
        want = np.asarray(jax.lax.top_k(jnp.asarray(scores), k)[1])
        got = top_k_indices(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(table[ids[0, :25]])) < 25       # ties were there to break


@pytest.mark.parametrize("search", ["soft", "hard"])
def test_jax_sim_export_scores_the_same_in_the_port(search, tmp_path, monkeypatch):
    """A directory the JAX ``export_model`` wrote for SIM loads into the
    port's ``load_scorer``; 20 rows in batches of 8 (the third padded), on
    the f32 path (``ML_FUNCTION_TPU_F32_MATMUL=1``), probabilities within
    1e-5."""
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    data = _data(search, n=20)
    jm, params, state = _jax_model(search)
    want = JaxScorer(jm, params, state, batch_size=8).predict_proba(data)
    hp = {"hidden": [16, 8], "long_behavior": ["hist_long"], "search": search}
    jax_export(str(tmp_path / "m"), "sim", _jax_fs(), params, state, hyperparams=hp)
    scorer = load_scorer(str(tmp_path / "m"), batch_size=8, device="cpu")
    assert scorer.model.name == "SIM"
    got = scorer.predict_proba(data)
    assert got.shape == (20,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_routes_not_ported_raise():
    fs = _port_fs()
    assert temb.row_tape(temb.RowTape("record")).tape.mode == "record"
    with pytest.raises(ValueError, match="share a vocab"):
        get_model("sim", fs, device="cpu", candidate=("cate",),
                  long_behavior=("hist_long",))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model("sim", fs)
