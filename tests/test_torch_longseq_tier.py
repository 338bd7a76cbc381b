"""The long-sequence tier's step-loop models, HPMN, MIMN and DTS: the port
(ml_function_tpu_torch) against the JAX package on the CPU, at 2 behavior
sequences, dim 4, L 8, B 32 (``make_behavior_data``: every history starts
with a valid step, the rest right-padded), with the JAX weights carried
across by the bridge, and R8, MIMN's gradient at an empty history.

Bars: with ``ML_FUNCTION_TPU_F32_MATMUL=1`` logits, the aux terms
(``cov_reg``, ``util_reg``, ``guide_loss``, ``emb_l2``) and the total loss
within 1e-6 (relative to the largest), and every parameter's step-1
gradient within 1e-6·max|g| + 1e-6·|g|, max|g| over the parameter's
top-level block. The target attentions over HPMN's 3 memory slots and
MIMN's slots and channels (``attn*``) are held at 1e-3 of their block's
max|g|: the softmax over a few similar slots does not see a shift of every
score, so their MLPs' gradients are residues of sums that cancel (MIMN's
``attn_mem`` reads 1.3e-4 of its block's max, its head bias's own gradient
is rounding alone). On the bf16 path logits within 1e-4 and gradients
within one bf16 step of max|g| (2^-8; the block's for ``attn*``), or bf16
neighbours where both are bf16 values (``ROADMAP.md`` R3).

Under the merge-scatter flag (``_USE_MERGE_SCATTER`` set in both packages)
HPMN's and MIMN's two sequence lookups go through ``fused_gather`` (its
plain version here, the JAX package's Pallas kernel in interpret mode).
DTS also runs with Δt from ``batch['seq']['hist_item_time']``.
"""

import contextlib
import os
import time

import jax
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_behavior_data as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops import embedding as jemb
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_behavior_data
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import embedding as temb
from ml_function_tpu_torch.serving import export_model, load_scorer
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

DATA_KW = dict(n_rows=32, n_items=30, n_cates=6, seq_len=8, embed_dim=4, seed=2)
MODELS = {"hpmn": {"hidden": (16, 8), "layers": 3},
          "mimn": {"hidden": (16, 8), "memory_slots": 3, "channels": 2},
          "dts": {"hidden": (16, 8)}}
# (model, f32 matmuls, variant): 'ms' the merge-scatter flag, 'time' Δt
CASES = ([(m, f32, "") for m in MODELS for f32 in (True, False)]
         + [("hpmn", True, "ms"), ("mimn", True, "ms"), ("dts", True, "time")])
F32_BAR = 1e-6
ATTN_F32_BAR = 1e-3


def _ids(cases):
    return [f"{m}-{'f32' if f else 'bf16'}{'-' + v if v else ''}" for m, f, v in cases]


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


def _with_time(data):
    """Δt of each step: 0.25 to 2, drawn from a fixed seed."""
    rng = np.random.default_rng(7)
    seq = dict(data["seq"])
    seq["hist_item_time"] = rng.uniform(0.25, 2.0, seq["hist_item"].shape).astype(np.float32)
    return dict(data, seq=seq)


def _batch(make, variant=""):
    fs, data = make(**DATA_KW)
    data = dict(data, weight=_weight())
    return fs, (_with_time(data) if variant == "time" else data)


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_run(name, data, fs, f32, merge_scatter=False):
    with _env(f32, merge_scatter):
        jm = jax_get_model(name, fs, **MODELS[name])
        params, state = jm.init(jax.random.PRNGKey(0))
        fn = jax.jit(jax.value_and_grad(
            lambda p: jloop.loss_fn(jm, p, state, data, None), has_aux=True))
        (total, (logits, _, aux, _)), grads = fn(params)
    return dict(params=jax.tree_util.tree_map(np.asarray, params),
                logits=np.asarray(logits), aux={k: float(v) for k, v in aux.items()},
                total=float(total), grads=_flat(grads))


@pytest.fixture(scope="module")
def jax_side():
    """Per case the JAX model's parameters, logits, aux terms, total loss and
    gradients (one jitted value_and_grad each), R8's batch, and the JAX
    side's seconds."""
    t = time.perf_counter()
    out = {}
    for name, f32, variant in CASES:
        fs, data = _batch(jax_make, variant)
        out[name, f32, variant] = _jax_run(name, data, fs, f32, variant == "ms")
    fs, data = _batch(jax_make)
    out["r8"] = _jax_run("mimn", _empty_first_row(data), fs, True)
    out["seconds"] = time.perf_counter() - t
    return out


def _port_model(name, params):
    fs, _ = _batch(make_behavior_data)
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


def _empty_first_row(data):
    """Row 0 with no behavior at all: MIMN's controller stays at 0, so its
    keys are their zero biases (R8)."""
    seq = {k: v.copy() for k, v in data["seq"].items()}
    for v in seq.values():
        v[0] = 0
    return dict(data, seq=seq)


@pytest.mark.parametrize("name,f32,variant", CASES, ids=_ids(CASES))
def test_loss_and_gradients_match_jax(jax_side, name, f32, variant, monkeypatch):
    """Logits, the aux terms and the total loss of one batch, and the
    gradient of every parameter; under the merge-scatter flag two
    ``fused_gather`` calls a forward, none without it."""
    side = jax_side[name, f32, variant]
    calls = []
    real = temb.fused_gather
    monkeypatch.setattr(temb, "fused_gather", lambda *a: calls.append(1) or real(*a))
    tm = _port_model(name, side["params"])
    _, tdata = _batch(make_behavior_data, variant)
    assert tdata["seq"]["hist_item"][:, 0].all()      # no R8 row in the parity batch
    with _env(f32, variant == "ms"):
        total, (logits, _, aux, _) = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
        total.backward()
    assert len(calls) == (2 if variant == "ms" else 0)
    assert set(aux) == set(side["aux"])
    fwd_bar = F32_BAR if f32 else 1e-4
    _close(logits.detach().numpy(), side["logits"], fwd_bar)
    for k, v in aux.items():
        _close(v.item(), side["aux"][k], fwd_bar)
    _close(total.item(), side["total"], fwd_bar)
    grads = side["grads"]
    assert {n for n, _ in tm.named_parameters()} == set(grads)
    block_max = {}
    for n, g in grads.items():
        top = n.split(".")[0]
        block_max[top] = max(block_max.get(top, 0.0), float(np.abs(g).max()))
    for pname, p in tm.named_parameters():
        want, top = grads[pname], pname.split(".")[0]
        if f32:
            bar = ATTN_F32_BAR if top.startswith("attn") else F32_BAR
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=F32_BAR,
                                       atol=bar * block_max[top], err_msg=pname)
        else:
            scale = block_max[top] if top.startswith("attn") else float(np.abs(want).max())
            _grad_close_bf16(p.grad.numpy(), want, scale, pname)


def test_jax_side_takes_seconds(jax_side):
    """The JAX side of every case, jitted once for the module, takes tens of
    seconds (about 30 alone); the bar leaves room for a loaded machine and
    catches a compile that runs away."""
    assert jax_side["seconds"] < 300, jax_side["seconds"]


def test_r8_mimn_zero_key_gradient(jax_side):
    """R8: at a history whose first step is padded, MIMN's controller state
    stays 0, so ``key_r`` and ``key_w`` give their zero-initialised biases
    as keys. JAX's gradient of ‖k‖ at k = 0 is NaN, which reaches the keys'
    parameters; PyTorch's norm has a finite gradient there, and the port
    keeps it. The forward agrees."""
    side = jax_side["r8"]
    assert np.isnan(side["grads"]["key_r.w"]).any() and np.isnan(side["grads"]["key_w.b"]).any()
    assert np.isfinite(side["logits"]).all()
    tm = _port_model("mimn", side["params"])
    _, tdata = _batch(make_behavior_data)
    with _env(True):
        total, (logits, _, aux, _) = tloop.loss_fn(
            tm, tloop.to_device(_empty_first_row(tdata), "cpu"))
        total.backward()
    _close(logits.detach().numpy(), side["logits"], F32_BAR)
    for n, p in tm.named_parameters():
        assert torch.isfinite(p.grad).all(), n


def test_hpmn_slowest_layer_ticks_every_fourth_valid_step():
    """With 3 valid steps (< 2^2) layer 2 never ticks: its cell's weights do
    not move the logits; with 8 they do (steps 4 and 8)."""
    fs, data = _batch(make_behavior_data)
    tm = get_model("hpmn", fs, device="cpu", **MODELS["hpmn"])
    short = {k: v.copy() for k, v in data["seq"].items()}
    for v in short.values():
        v[:, 3:] = 0
    full = dict(data)
    runs = {}
    for label, batch in (("short", dict(data, seq=short)), ("full", full)):
        with torch.no_grad():
            base = tm(batch)[0]
            for p in tm.cells[2].parameters():
                p.add_(0.3)
            moved = tm(batch)[0]
            for p in tm.cells[2].parameters():
                p.sub_(0.3)
        runs[label] = float((base - moved).abs().max())
    assert runs["short"] <= 1e-6 < runs["full"], runs


def test_dts_export_scores_in_the_port(jax_side, tmp_path):
    """DTS through ``export_model`` → ``load_scorer(device='cpu')``, scored
    with Δt in the batch: the JAX model's scores."""
    side = jax_side["dts", True, "time"]
    tm = _port_model("dts", side["params"])
    fs, tdata = _batch(make_behavior_data, "time")
    path = export_model(str(tmp_path / "m"), "dts", fs, tm, hyperparams={"hidden": [16, 8]})
    scorer = load_scorer(path, batch_size=12, device="cpu")
    with _env(True):
        got = scorer.predict_proba({k: tdata[k] for k in ("dense", "sparse", "seq")})
    want = 1.0 / (1.0 + np.exp(-side["logits"].astype(np.float64)))
    assert scorer.model.name == "DTS" and got.shape == (32,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_long_sequence_tier_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    fs, _ = _batch(make_behavior_data)
    for name in MODELS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_model(name, fs)


@pytest.mark.parametrize("name", ["sim", "mind"])
def test_a_deep_copy_reads_its_own_weights(name):
    """SIM's forward calls its DIEN core's ``interest`` and MIND has
    ``interests``: a deep copy (an EMA or a snapshot of a model) must run
    them on the copy's parameters, as a model built from the copy's state
    does, not on the original's."""
    import copy

    fs, data = _batch(make_behavior_data)
    kw = {"hidden": (16, 8)}
    tm = get_model(name, fs, device="cpu", **kw)
    twin = copy.deepcopy(tm)
    with torch.no_grad():
        for p in twin.parameters():
            p.mul_(1.5)
    fresh = get_model(name, fs, device="cpu", **kw)
    fresh.load_state_dict(twin.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(twin(data)[0], fresh(data)[0], rtol=0, atol=0)
        assert not torch.equal(twin(data)[0], tm(data)[0])
        if name == "mind":
            torch.testing.assert_close(twin.interests(data), fresh.interests(data),
                                       rtol=0, atol=0)
