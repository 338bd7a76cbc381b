"""DSSM, DeepMCP and DICM, and the ``ops/core`` score heads: the port
(ml_function_tpu_torch) against the JAX package on the CPU, with the JAX
weights carried across by the bridge, on ``make_image_ctr_data`` (the
behavior schema: item and cate candidates, two other sparse fields, two
histories of 8, dim 4, and 8-wide image vectors), B 64 with a padded tail
of 5 rows.

Bars, as ``tests/test_torch_interaction_ext.py`` holds them: with
``ML_FUNCTION_TPU_F32_MATMUL=1`` logits, aux terms and the total loss
within 1e-6 of the largest and every parameter's step-1 gradient within
1e-6·max|g| + 1e-6·|g|, max|g| over the parameter's top-level block; on
the bf16 path 1e-4 and one bf16 step of max|g| (2^-8), or bf16 neighbours
where both gradients are bf16 values (``ROADMAP.md`` R3); DICM's target
attentions' MLPs at 1e-5 of their block's max|g| (``ATTN_F32_BAR``). DICM also runs
with the merge-scatter flag's attribute set in both packages: its two
history lookups take ``fused_gather`` (the kernel's plain version here, the
JAX Pallas kernel in interpret mode).
"""

import contextlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_image_ctr_data as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops import core as jcore
from ml_function_tpu.ops import embedding as jemb
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_image_ctr_data
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import core as tcore
from ml_function_tpu_torch.ops import embedding as temb
from ml_function_tpu_torch.ops.base import init_parameters
from ml_function_tpu_torch.serving import export_model, load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

DATA_KW = dict(n_rows=64, n_items=30, n_cates=6, seq_len=8, img_dim=8,
               embed_dim=4, seed=2)
MODELS = {
    "dssm": {"hidden": (16, 8)},
    "deepmcp": {"hidden": (16, 8), "match_hidden": (8,), "match_dim": 6,
                "corr_hidden": (8,)},
    "dicm": {"img_dim": 8, "img_tower": (6,), "hidden": (16, 8)},
}
# (model, f32 matmuls, merge-scatter flag)
CASES = ([(m, f32, False) for m in MODELS for f32 in (True, False)]
         + [("dicm", True, True)])
F32_BAR = 1e-6
# DICM's target attentions score steps through a softmax, which no shift of
# every score moves, so their MLPs' gradients are residues of sums that
# cancel (the head's, 3e-5 against a block max of 1e-4, differ by 5e-10;
# its bias's, exactly 0 but for rounding, is 1e-10): they are held at 1e-5
# of their block's max|g|, and on the bf16 path at one bf16 step of it
ATTN_BLOCKS = ("id_attn", "img_attn")
ATTN_F32_BAR = 1e-5


def _ids(cases):
    return [f"{m}-{'f32' if f else 'bf16'}{'-merge_scatter' if ms else ''}"
            for m, f, ms in cases]


@contextlib.contextmanager
def _env(f32: bool, merge_scatter: bool = False):
    """The matmul switch (read at call time by both packages) and the
    merge-scatter attribute of both (read at import)."""
    saved = (os.environ.get("ML_FUNCTION_TPU_F32_MATMUL"), jemb._USE_MERGE_SCATTER,
             temb._USE_MERGE_SCATTER)
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1" if f32 else "0"
    jemb._USE_MERGE_SCATTER = temb._USE_MERGE_SCATTER = merge_scatter
    try:
        yield
    finally:
        env, jemb._USE_MERGE_SCATTER, temb._USE_MERGE_SCATTER = saved
        if env is None:
            os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
        else:
            os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = env


def _weight():
    w = np.ones(DATA_KW["n_rows"], np.float32)
    w[-5:] = 0.0
    return w


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the JAX model's parameters, logits, aux terms, total loss
    and gradients (one jitted value_and_grad each); DSSM's towers and
    in-batch loss; the JAX side's seconds."""
    t = time.perf_counter()
    fs, data = jax_make(**DATA_KW)
    data = dict(data, weight=_weight())
    out = {}
    for name, f32, ms in CASES:
        with _env(f32, ms):
            jm = jax_get_model(name, fs, **MODELS[name])
            params, state = jm.init(jax.random.PRNGKey(0))
            fn = jax.jit(jax.value_and_grad(
                lambda p: jloop.loss_fn(jm, p, state, data, None), has_aux=True))
            (total, (logits, _, aux, _)), grads = fn(params)
            side = dict(params=jax.tree_util.tree_map(np.asarray, params),
                        logits=np.asarray(logits),
                        aux={k: float(v) for k, v in aux.items()},
                        total=float(total), grads=_flat(grads))
            if name == "deepmcp":
                _, _, eval_aux = jm.apply(params, state, data, train=False)
                side["eval_aux"] = sorted(eval_aux)
            if name == "dssm":
                side["user_vec"] = np.asarray(jm.user_vec(params, data))
                side["item_vec"] = np.asarray(jm.item_vec(params, data))
                ib, ib_g = jax.value_and_grad(jm.in_batch_softmax_loss)(params, data)
                side["in_batch"], side["in_batch_grads"] = float(ib), _flat(ib_g)
        out[name, f32, ms] = side
    out["seconds"] = time.perf_counter() - t
    return out


def _port_batch():
    fs, data = make_image_ctr_data(**DATA_KW)
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


def _grads_close(tm, grads, f32):
    assert {n for n, _ in tm.named_parameters()} == set(grads)
    block_max = {}
    for n, g in grads.items():
        top = n.split(".")[0]
        block_max[top] = max(block_max.get(top, 0.0), float(np.abs(g).max()))
    for pname, p in tm.named_parameters():
        want = grads[pname]
        top = pname.split(".")[0]
        if f32:
            bar = ATTN_F32_BAR if top in ATTN_BLOCKS else F32_BAR
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=F32_BAR,
                                       atol=bar * block_max[top], err_msg=pname)
        else:
            scale = block_max[top] if top in ATTN_BLOCKS else float(np.abs(want).max())
            _grad_close_bf16(p.grad.numpy(), want, scale, pname)


def test_image_ctr_data_matches_jax():
    fs, data = jax_make(**DATA_KW)
    tfs, tdata = make_image_ctr_data(**DATA_KW)
    assert tfs.fingerprint == fs.fingerprint
    for k in ("sparse", "label", "image", "hist_image"):
        np.testing.assert_array_equal(tdata[k], data[k])
    for k in data["seq"]:
        np.testing.assert_array_equal(tdata["seq"][k], data["seq"][k])


@pytest.mark.parametrize("name,f32,ms", CASES, ids=_ids(CASES))
def test_loss_and_gradients_match_jax(jax_side, name, f32, ms, monkeypatch):
    """Logits, aux terms (DeepMCP's ``match`` and ``corr`` in train mode)
    and the total loss of one batch, and every parameter's gradient; under
    the merge-scatter flag DICM's two history lookups take ``fused_gather``."""
    side = jax_side[name, f32, ms]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    monkeypatch.setattr(temb, "_USE_MERGE_SCATTER", ms)
    calls = []
    real = temb.fused_gather
    monkeypatch.setattr(temb, "fused_gather",
                        lambda t, i: calls.append(i.shape[0]) or real(t, i))
    fwd_bar = F32_BAR if f32 else 1e-4
    tm = _port_model(name, side["params"])
    _, tdata = _port_batch()
    total, (logits, _, aux, _) = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    n = DATA_KW["n_rows"] * DATA_KW["seq_len"]
    assert calls == ([n, n] if ms else [])
    assert set(aux) == set(side["aux"])
    _close(logits.detach().numpy(), side["logits"], fwd_bar)
    for k, v in aux.items():
        _close(v.item(), side["aux"][k], fwd_bar)
    _close(total.item(), side["total"], fwd_bar)
    _grads_close(tm, side["grads"], f32)


def test_deepmcp_scores_with_the_prediction_subnet_alone(jax_side):
    """Out of train mode DeepMCP's aux holds ``emb_l2`` alone, in both."""
    side = jax_side["deepmcp", True, False]
    tm = _port_model("deepmcp", side["params"])
    _, tdata = _port_batch()
    with torch.no_grad():
        _, _, aux = tm(tdata, train=False)
    assert sorted(aux) == side["eval_aux"] == ["emb_l2"]


def test_dssm_towers_and_in_batch_loss_match_jax(jax_side, monkeypatch):
    """``user_vec``, ``item_vec`` (unit vectors) and the in-batch softmax
    loss with its gradients, with f32 matmuls."""
    side = jax_side["dssm", True, False]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    tm = _port_model("dssm", side["params"])
    _, tdata = _port_batch()
    u, v = tm.user_vec(tdata), tm.item_vec(tdata)
    _close(u.detach().numpy(), side["user_vec"], F32_BAR)
    _close(v.detach().numpy(), side["item_vec"], F32_BAR)
    np.testing.assert_allclose(torch.linalg.vector_norm(u, dim=-1).detach().numpy(),
                               1.0, rtol=1e-6)
    loss = tm.in_batch_softmax_loss(tdata)
    loss.backward()
    _close(loss.item(), side["in_batch"], F32_BAR)
    _grads_close(tm, side["in_batch_grads"], True)


def test_r9_dssm_zero_tower_gradient(jax_side, monkeypatch):
    """DSSM's unit vector is x / (‖x‖ + 1e-9): at a tower output of exactly
    0 (the item tower's head zeroed) JAX's gradient of the norm is NaN and
    spreads to the tower's weights, where the port's is finite (R9); the
    logits agree (all 0)."""
    side = jax_side["dssm", True, False]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    fs, data = jax_make(**DATA_KW)
    jm = jax_get_model("dssm", fs, **MODELS["dssm"])
    params = jax.tree_util.tree_map(jnp.asarray, side["params"])
    params["i_mlp"]["head"] = jax.tree_util.tree_map(jnp.zeros_like,
                                                     params["i_mlp"]["head"])
    (total, (logits, *_)), grads = jax.value_and_grad(
        lambda p: jloop.loss_fn(jm, p, {}, dict(data, weight=_weight()), None),
        has_aux=True)(params)
    assert not np.asarray(logits).any()
    assert np.isnan(np.asarray(grads["i_mlp"]["head"]["w"])).all()
    tm = _port_model("dssm", jax.tree_util.tree_map(np.asarray, params))
    _, tdata = _port_batch()
    t_total, (t_logits, *_) = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    t_total.backward()
    assert not t_logits.detach().any()
    _close(t_total.item(), float(total), F32_BAR)
    assert all(torch.isfinite(p.grad).all() for p in tm.parameters())


def test_dicm_export_scores_in_the_port(jax_side, tmp_path):
    """DICM through ``export_model`` → ``load_scorer(device='cpu')``, its
    image tower a hyperparameter: the scores are the JAX model's."""
    side = jax_side["dicm", True, False]
    tm = _port_model("dicm", side["params"])
    fs, tdata = _port_batch()
    hp = {k: list(v) if isinstance(v, tuple) else v for k, v in MODELS["dicm"].items()}
    path = export_model(str(tmp_path / "m"), "dicm", fs, tm, hyperparams=hp)
    scorer = load_scorer(path, batch_size=24, device="cpu")
    with _env(True):
        got = scorer.predict_proba({k: v for k, v in tdata.items()
                                    if k not in ("label", "weight")})
    want = 1.0 / (1.0 + np.exp(-side["logits"].astype(np.float64)))
    assert scorer.model.name == "DICM" and got.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_jax_side_takes_seconds(jax_side):
    """The JAX side of every case, compiled and run once for the module;
    the bar catches a compile that runs away."""
    assert jax_side["seconds"] < 300, jax_side["seconds"]


def test_new_models_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    fs, _ = _port_batch()
    for name in MODELS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(name, fs)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_score_heads_match_jax():
    """``ScoreHead``, ``MergeScoreHead``, ``intra_view_pool`` and ``Align``
    (its ``proj{i}`` keys only for the inputs of another width) against
    the JAX heads, with f32 matmuls, and their parameters' gradients."""
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(5, 3)).astype(np.float32),
          rng.normal(size=(5, 2, 4)).astype(np.float32)]
    key = jax.random.PRNGKey(1)
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    try:
        # ScoreHead: a sum of (B,) and (B, 1) contributions plus the bias
        contrib = [rng.normal(size=(5,)).astype(np.float32),
                   rng.normal(size=(5, 1)).astype(np.float32)]
        jp = {"bias": jnp.asarray(0.3)}
        want = jcore.ScoreHead()(jp, [jnp.asarray(c) for c in contrib])
        head = tcore.ScoreHead()
        params_from_numpy(head, _np_tree(jp))
        _close(head([torch.tensor(c) for c in contrib]).detach().numpy(), want, F32_BAR)
        assert not list(tcore.ScoreHead(use_bias=False).parameters())
        # MergeScoreHead over flattened inputs of 3 + 8 columns
        jm = jcore.MergeScoreHead(11)
        jp = jm.init(key)
        want, jg = jax.value_and_grad(
            lambda p: jnp.sum(jm(p, [jnp.asarray(x) for x in xs]) ** 2))(jp)
        merge = tcore.MergeScoreHead(11)
        params_from_numpy(merge, _np_tree(jp))
        got = (merge([torch.tensor(x) for x in xs]) ** 2).sum()
        got.backward()
        _close(got.item(), float(want), F32_BAR)
        _close(merge.head.w.grad.numpy(), jg["head"]["w"], F32_BAR)
        # intra_view_pool: the mean over axis 1, kept
        _close(tcore.intra_view_pool(torch.tensor(xs[1])).numpy(),
               jcore.intra_view_pool(jnp.asarray(xs[1])), F32_BAR)
        # Align: inputs of width 3 and 4 and 5 to 4 (the second passes)
        x3 = rng.normal(size=(5, 5)).astype(np.float32)
        inputs = [xs[0], xs[1], x3]
        ja = jcore.Align((3, 4, 5), 4)
        jp = ja.init(key)
        assert sorted(jp) == ["proj0", "proj2"]
        want = ja(jp, [jnp.asarray(x) for x in inputs])
        align = tcore.Align((3, 4, 5), 4)
        init_parameters(align, torch.Generator().manual_seed(0))
        params_from_numpy(align, _np_tree(jp))
        got = align([torch.tensor(x) for x in inputs])
        for g, w in zip(got, want):
            _close(g.detach().numpy(), w, F32_BAR)
        assert torch.equal(got[1], torch.tensor(xs[1]))
    finally:
        os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
