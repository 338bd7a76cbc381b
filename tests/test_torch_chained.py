"""The chained train step: the port's ``stack_batches``,
``make_chained_train_step`` and ``fit(steps_per_call=K)`` against the JAX
package's on the CPU, the optimizers with their update count on a tensor
against optax over 20 updates, and the CPU's proxy for a CUDA graph's
safety (what a replay reads and writes keeps its storage).

Inputs are made with numpy from a seed; the JAX parameters cross by key
path. Tolerances, each with its reason:

- ``stack_batches`` and ``iter_groups``: exact (copies);
- a chained group of K = 4 SGD steps (momentum 0.9) with f32 matmuls on
  both sides (``ML_FUNCTION_TPU_F32_MATMUL=1``): the losses and logits
  within 1e-5, and each parameter's change over the group within 1e-3 of
  the largest change in its block (the first key of its path). The two
  packages differ only in the f32 summation order (and the scatter-add
  order of the embedding gradient, which moves a table row's sum by an ulp
  or so of its largest term), which SGD carries into the parameters
  linearly: 1e-3 is ``tests/test_torch_train.py``'s bar for gradients, and
  the block's largest change is the scale because DIEN's target-attention
  MLP gets gradients that are residues of cancelling sums
  (``tests/test_torch_sequence.py``). Adam's first steps, about
  lr·sign(g), would turn such a residue into 2·lr, hence SGD;
- the chained ``fit``: steps and counts exact, the held-out AUC within 0.01
  of the JAX chained ``fit``'s (``tests/test_torch_train.py``'s bar for
  ``fit``), and the port's chained and unchained runs the same bits (the
  same single steps in the same order);
- optimizers over 20 updates of fixed gradients: rtol 1e-5 with atol
  1e-5·max|p| (the same f32 formulas; XLA's and libm's ``pow``, ``cos``
  and ``rsqrt`` may differ in the last bit); schedules at rel 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ml_function_tpu.models.sequence as jseq
import ml_function_tpu.ops.embedding as jemb
from ml_function_tpu.features.synthetic import make_behavior_data as jax_make_behavior
from ml_function_tpu.features.synthetic import make_criteo_like as jax_make_criteo
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.ops.recurrent import GRU as JGRU
from ml_function_tpu.train import loop as jloop
from ml_function_tpu.train import optimizers as joptim
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import (make_behavior_data,
                                                      make_criteo_like)
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import core as tcore
from ml_function_tpu_torch.ops import embedding as temb
from ml_function_tpu_torch.ops.base import init_parameters
from ml_function_tpu_torch.ops.kernels import cin as tcin
from ml_function_tpu_torch.ops.kernels import launches
from ml_function_tpu_torch.train import loop as tloop
from ml_function_tpu_torch.train import metrics as tmetrics
from ml_function_tpu_torch.train import optimizers as toptim

torch.set_num_threads(1)

K = 4
LR = 0.05
CRITEO_KW = dict(n_rows=K * 256, n_dense=4, n_sparse=6, vocab_size=50,
                 embed_dim=4, seed=1)
BEHAVIOR_KW = dict(n_rows=K * 32, n_items=30, n_cates=6, seq_len=8,
                   embed_dim=4, seed=2)
# (JAX data maker, port data maker, data, model, hyperparameters, batch)
CHAINS = {
    # B 256: the CIN layer takes cin_layer_t, whose plain version runs here
    "xdeepfm": (jax_make_criteo, make_criteo_like, CRITEO_KW, "xdeepfm",
                {"cin_hidden": (16, 16), "hidden": (16, 8)}, 256),
    # the (AU)GRU kernel route and the merge-scatter gradient (plain versions)
    "dien": (jax_make_behavior, make_behavior_data, BEHAVIOR_KW, "dien",
             {"hidden": (16, 8)}, 32),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _at(tree, name):
    for k in name.split("."):
        tree = tree[k]
    return np.asarray(tree)


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _batches(data, batch):
    return list(jloop.iter_batches(data, batch))


def _jax_chain(name):
    """The JAX chained step's (K,) losses, (K, B) logits, and the
    parameters before and after the group, jitted."""
    jmake, _, kw, model, hp, batch = CHAINS[name]
    fs, data = jmake(**kw)
    kernel = name == "dien"
    saved = jseq.GRU, jseq.AUGRU, jemb._USE_MERGE_SCATTER
    if kernel:
        jseq.GRU = jseq.AUGRU = lambda *a, **k: JGRU(*a, kernel="pallas", **k)
        jemb._USE_MERGE_SCATTER = True
    try:
        jm = jax_get_model(model, fs, **hp)
        params, state = jm.init(jax.random.PRNGKey(0))
        opt = joptim.make_optimizer("sgd", LR, momentum=0.9)
        ts = jloop.TrainState(params=params, opt_state=opt.init(params),
                              model_state=state, step=jnp.zeros((), jnp.int32),
                              rng=jax.random.PRNGKey(1))
        p0 = _np_tree(params)
        ts, outs = jloop.make_chained_train_step(jm, opt, K, donate=False)(
            ts, jloop.stack_batches(_batches(data, batch)))
    finally:
        jseq.GRU, jseq.AUGRU, jemb._USE_MERGE_SCATTER = saved
    return p0, _np_tree(ts.params), {k: np.asarray(v) for k, v in outs.items()}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX side of every test here, once for the module, with f32
    matmuls (read while tracing)."""
    env = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1"
    try:
        chains = {name: _jax_chain(name) for name in CHAINS}
    finally:
        if env is None:
            os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL")
        else:
            os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = env
    fs, data = jax_make_criteo(**SMALL_FIT_DATA)
    jm = jax_get_model("deepfm", fs, hidden=(8,))
    _, fit = jloop.fit(jm, data, eval_data=data, steps_per_call=K, **FIT_KW)
    init_rng, _ = jax.random.split(jax.random.PRNGKey(FIT_KW["seed"]))
    params, state = jm.init(init_rng)
    return {"chains": chains, "fit": (fit, (_np_tree(params), state))}


# ---------------------------------------------------------------------------
# stack_batches


def test_stack_batches_is_the_reference():
    _, data = make_behavior_data(**BEHAVIOR_KW)
    batches = _batches(data, 32)
    want = jloop.stack_batches(batches)
    got = tloop.stack_batches(batches)
    assert sorted(got) == sorted(want) and sorted(got["seq"]) == sorted(want["seq"])
    for k in got:
        if k == "seq":
            for s in got["seq"]:
                assert got["seq"][s].dtype == want["seq"][s].dtype
                np.testing.assert_array_equal(got["seq"][s], want["seq"][s])
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape[0] == K
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("n_rows", [1100, 1000])
def test_iter_groups_are_the_stacked_batches(n_rows):
    """1100 rows at B 128: two groups of 4 and a padded tail batch; 1000:
    two groups, the second ending in the padded batch."""
    _, data = make_behavior_data(**dict(BEHAVIOR_KW, n_rows=n_rows))
    batches = list(tloop.iter_batches(data, 128, shuffle=True, seed=3))
    got = list(tloop.iter_groups(data, 128, K, shuffle=True, seed=3))
    full = len(batches) // K * K
    assert [kind for kind, _ in got] == ["group"] * (full // K) + ["batch"] * (len(batches) - full)
    want = [tloop.stack_batches(batches[i:i + K]) for i in range(0, full, K)] + batches[full:]
    for (_, g), w in zip(got, want):
        assert sorted(g) == sorted(w) and sorted(g["seq"]) == sorted(w["seq"])
        for k in g:
            for name, a in (g[k].items() if k == "seq" else [(k, g[k])]):
                b = w["seq"][name] if k == "seq" else w[k]
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the chained step against the reference's


def _port_model(name, params):
    _, tmake, kw, model, hp, _ = CHAINS[name]
    fs, data = tmake(**kw)
    tm = get_model(model, fs, device="cpu", **hp)
    params_from_numpy(tm, params)
    if name == "dien":
        tm.gru1.kernel = tm.gru2.kernel = "pallas"
    return tm, data


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chained_step_matches_jax(jax_side, name, monkeypatch):
    p0, p1, want = jax_side["chains"][name]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    monkeypatch.setattr(temb, "_USE_MERGE_SCATTER", name == "dien")
    tm, data = _port_model(name, p0)
    opt = toptim.make_optimizer("sgd", LR, momentum=0.9).init(tm)
    step = tloop.make_chained_train_step(tm, opt, K)
    group = tloop.stack_batches(_batches(data, CHAINS[name][5]))
    got = step(group)
    assert got["loss"].shape == (K,) and got["logits"].shape == want["logits"].shape
    _close(got["loss"].numpy(), want["loss"], 1e-5)
    _close(got["logits"].numpy(), want["logits"], 1e-5)
    np.testing.assert_array_equal(got["label"].numpy(), want["label"])
    np.testing.assert_array_equal(got["weight"].numpy(), want["weight"])
    assert int(opt.count) == K and step.groups == 1
    got_d = {n: p.detach().numpy() - _at(p0, n) for n, p in tm.named_parameters()}
    want_d = {n: _at(p1, n) - _at(p0, n) for n in got_d}
    block_max = {}
    for n, d in want_d.items():
        b = n.split(".")[0]
        block_max[b] = max(block_max.get(b, 0.0), float(np.abs(d).max()))
    for n, d in got_d.items():
        np.testing.assert_allclose(d, want_d[n], rtol=1e-3,
                                   atol=1e-3 * block_max[n.split(".")[0]], err_msg=n)


def test_chained_step_is_the_single_steps():
    """On the CPU the chained step runs the single steps in order: the same
    bits as K calls of ``make_train_step``, the metric fold included."""
    fs, data = make_criteo_like(**CRITEO_KW)
    batches = _batches(data, 256)
    runs = []
    for chained in (False, True):
        tm = get_model("xdeepfm", fs, device="cpu", **CHAINS["xdeepfm"][4])
        opt = toptim.make_optimizer("adam", 1e-2).init(tm)
        metrics = tmetrics.init_metrics()
        if chained:
            step = tloop.make_chained_train_step(tm, opt, K, metrics)
            losses = step(tloop.stack_batches(batches))["loss"]
        else:
            one = tloop.make_train_step(tm, opt)
            outs = [one(b) for b in batches]
            for o, b in zip(outs, batches):
                tmetrics.update_metrics_(metrics, o["logits"], o["label"],
                                         torch.from_numpy(b["weight"]))
            losses = torch.stack([o["loss"] for o in outs])
        runs.append((losses, metrics, {k: v.clone() for k, v in tm.state_dict().items()}))
    (l1, m1, s1), (l2, m2, s2) = runs
    assert torch.equal(l1, l2)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


def test_chained_step_refuses_a_group_of_another_length():
    fs, data = make_criteo_like(**CRITEO_KW)
    tm = get_model("deepfm", fs, device="cpu", hidden=(8,))
    step = tloop.make_chained_train_step(tm, toptim.make_optimizer().init(tm), K + 1)
    with pytest.raises(ValueError, match="chain of 5"):
        step(tloop.stack_batches(_batches(data, 256)))
    with pytest.raises(ValueError, match="chain"):
        tloop.make_chained_train_step(tm, toptim.make_optimizer().init(tm), 0)


# ---------------------------------------------------------------------------
# fit(steps_per_call=K)

SMALL_FIT_DATA = dict(n_rows=1100, n_dense=2, n_sparse=4, vocab_size=11,
                      embed_dim=4, seed=13)
# 1100 rows at B 128: 9 batches an epoch, two groups of 4 and a tail of 1
FIT_KW = dict(epochs=2, batch_size=128, learning_rate=5e-3, seed=5)


def test_chained_fit_matches_jax_and_the_unchained_fit(jax_side):
    want, init = jax_side["fit"]
    fs, data = make_criteo_like(**SMALL_FIT_DATA)
    got = []
    for spc in (K, 1):
        tm = get_model("deepfm", fs, device="cpu", hidden=(8,))
        ts, res = tloop.fit(tm, data, eval_data=data, init_params=init,
                            steps_per_call=spc, **FIT_KW)
        got.append(res)
        assert ts.step == res.steps == int(ts.optimizer.count)
    chained, plain = got
    assert chained.steps == want.steps == 18
    assert chained.train_metrics["count"] == want.train_metrics["count"] == 2 * 1100
    assert chained.eval_metrics["count"] == want.eval_metrics["count"] == 1100
    assert abs(chained.eval_metrics["auc"] - want.eval_metrics["auc"]) < 0.01
    assert chained.train_metrics == plain.train_metrics
    assert chained.eval_metrics == plain.eval_metrics
    assert chained.examples_per_sec > 0


# ---------------------------------------------------------------------------
# optimizers with the count on a tensor, against optax over 20 updates


def _fixed_grads(n=20, seed=7):
    rng = np.random.default_rng(seed)
    shapes = {"embedding": {"table": (12, 4), "linear": (12, 1)},
              "mlp": {"w": (5, 3), "b": (3,)}, "bias": ()}
    p0 = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1, a.shape).astype(np.float32), p0)
        for _ in range(n)]
    return p0, grads


NAMES = ["embedding.table", "embedding.linear", "mlp.w", "mlp.b", "bias"]


def _optax_run(opt, p0, grads):
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(params)
    update = jax.jit(opt.update)
    for g in grads:
        updates, state = update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    return _np_tree(params)


def _rules(opt):
    return list(opt.parts.values()) if isinstance(opt, toptim.Partitioned) else [opt]


RULE_CASES = [
    ("adam", {}), ("adamw", {"weight_decay": 0.1}), ("adagrad", {}),
    ("sgd", {"momentum": 0.9}), ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("ftrl", {"lambda1": 0.05, "lambda2": 0.1}), ("partitioned", {}),
    ("adam", {"schedule": "cosine", "decay_steps": 12, "end_lr_frac": 0.1}),
    ("sgd", {"schedule": "exponential", "transition_steps": 3, "decay_rate": 0.5}),
    ("adagrad", {"schedule": "warmup_cosine", "warmup_steps": 5,
                 "decay_steps": 15, "end_lr_frac": 0.1}),
]


@pytest.mark.parametrize("name,kw", RULE_CASES,
                         ids=[f"{n}-{kw.get('schedule', '')}{i}" for i, (n, kw) in
                              enumerate(RULE_CASES)])
def test_optimizer_with_a_device_count_matches_optax_over_20_updates(name, kw):
    p0, grads = _fixed_grads()
    if name == "partitioned":
        want = _optax_run(joptim.embedding_partitioned(optax.adam(0.01)), p0, grads)
        spec = toptim.embedding_partitioned(toptim.make_optimizer("adam", 0.01))
    else:
        want = _optax_run(joptim.make_optimizer(name, LR, **kw), p0, grads)
        spec = toptim.make_optimizer(name, LR, **kw)
    named = [(n, torch.nn.Parameter(torch.from_numpy(_at(p0, n).copy()))) for n in NAMES]
    opt = spec.init(named)
    for g in grads:
        for n, p in named:
            p.grad = torch.from_numpy(_at(g, n).copy())
        opt.step()
    for rule in _rules(opt):
        assert rule.count.dtype == torch.int32 and rule.count.dim() == 0
        assert int(rule.count) == len(grads)
    for n, p in named:
        _close(p.detach().numpy(), _at(want, n), 1e-5)


SCHEDULES = [("cosine", {"decay_steps": 10, "end_lr_frac": 0.1}),
             ("exponential", {"transition_steps": 3, "decay_rate": 0.5}),
             ("warmup_cosine", {"warmup_steps": 3, "decay_steps": 10}),
             ("warmup_cosine", {"warmup_steps": 0, "decay_steps": 10,
                                "end_lr_frac": 0.2})]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedules_on_an_int32_count_tensor_match_optax(name, kw):
    want = joptim.make_lr_schedule(name, 0.1, **kw)
    got = toptim.make_lr_schedule(name, 0.1, **kw)
    for count in range(21):
        c = torch.tensor(count, dtype=torch.int32)
        g = got(c)
        assert g.dtype == torch.float32 and g.dim() == 0
        assert float(g) == pytest.approx(float(want(jnp.int32(count))), rel=1e-6,
                                         abs=1e-9), count


def test_injected_learning_rate_is_a_device_scalar():
    opt = toptim.make_optimizer("adam", 0.05, inject_lr=True).init(
        [("w", torch.nn.Parameter(torch.zeros(3)))])
    lr = opt.lr_tensor
    toptim.set_learning_rate(opt, 0.01)
    assert opt.lr_tensor is lr and float(lr) == np.float32(0.01)
    assert toptim.get_learning_rate(opt) == 0.01


# ---------------------------------------------------------------------------
# the CPU's proxy for graph safety


class _BatchNormTower(torch.nn.Module):
    """A model of the step's contract around a BatchNorm MLP (no registry
    model has BatchNorm)."""

    def __init__(self):
        super().__init__()
        self.mlp = tcore.MLP(4, (8,), norm="batch", out_dim=1)
        init_parameters(self, torch.Generator().manual_seed(0))

    def forward(self, batch, train=False):
        return self.mlp(batch["dense"], train)[:, 0], {}, {}


def _ptrs(opt, model, metrics):
    out = {}
    for r, rule in enumerate(_rules(opt)):
        out[f"count{r}"] = rule.count.data_ptr()
        if rule.lr_tensor is not None:
            out[f"lr{r}"] = rule.lr_tensor.data_ptr()
        for i, p in enumerate(rule.param_groups[0]["params"]):
            for k, v in rule.state[p].items():
                out[f"{r}.{i}.{k}"] = v.data_ptr()
    out.update({f"buffer {n}": b.data_ptr() for n, b in model.named_buffers()})
    out.update({f"param {n}": p.data_ptr() for n, p in model.named_parameters()})
    out.update({f"metric {k}": v.data_ptr() for k, v in metrics.items()})
    return out


@pytest.mark.parametrize("rule", ["adam", "adagrad", "sgd", "ftrl", "partitioned",
                                  "plateau"])
def test_what_a_replay_touches_keeps_its_storage(rule):
    """Across groups every optimizer state tensor, the count and the
    injected LR, the parameters, the BatchNorm buffers and the metric
    buffers stay where they were: a CUDA graph replays fixed addresses."""
    rng = np.random.default_rng(0)
    model = _BatchNormTower()
    specs = {"sgd": toptim.make_optimizer("sgd", 0.1, momentum=0.9),
             "partitioned": toptim.embedding_partitioned(toptim.make_optimizer("adam")),
             "plateau": toptim.make_optimizer("adam", 1e-2, inject_lr=True)}
    opt = (specs.get(rule) or toptim.make_optimizer(rule, 0.05)).init(model)
    metrics = tmetrics.init_metrics()
    step = tloop.make_chained_train_step(model, opt, K, metrics)
    seen = None
    for _ in range(3):
        group = {"dense": rng.normal(size=(K, 16, 4)).astype(np.float32),
                 "label": (rng.random((K, 16)) < 0.5).astype(np.float32),
                 "weight": np.ones((K, 16), np.float32)}
        step(group)
        if rule == "plateau":
            toptim.set_learning_rate(opt, 5e-3)
        ptrs = _ptrs(opt, model, metrics)
        assert seen is None or ptrs == seen
        seen = ptrs
    assert any(k.startswith("buffer") for k in seen) and float(metrics["count"]) == 3 * K * 16
    assert int(model.mlp.layer0.norm.mean.abs().sum() > 0)


def test_a_restore_keeps_the_state_a_replay_reads(tmp_path):
    """A checkpoint restored into an optimizer that has stepped (a chained
    step's graph reads its state) fills its count, injected LR and state in
    place, with the checkpoint's values."""
    from ml_function_tpu_torch.train import checkpoint as ckpt
    fs, data = make_criteo_like(**CRITEO_KW)
    tm = get_model("deepfm", fs, device="cpu", hidden=(8,))
    opt = toptim.make_optimizer("adam", 1e-2, inject_lr=True).init(tm)
    step = tloop.make_chained_train_step(tm, opt, K)
    group = tloop.stack_batches(_batches(data, 256))
    step(group)
    want = ckpt.state_arrays(tloop.TrainState(tm, opt, K))
    ckpt.save_checkpoint(str(tmp_path), tloop.TrainState(tm, opt, K))
    before = _ptrs(opt, tm, tmetrics.init_metrics())
    step(group)
    toptim.set_learning_rate(opt, 1e-3)
    got, _, _ = ckpt.restore_latest(str(tmp_path), tloop.TrainState(tm, opt, 0))
    assert got.step == K and int(opt.count) == K and float(opt.lr_tensor) == np.float32(1e-2)
    assert _ptrs(opt, tm, {}) == {k: v for k, v in before.items() if not k.startswith("metric")}
    have = ckpt.state_arrays(got)
    assert sorted(have) == sorted(want)
    assert all(np.array_equal(have[k], want[k]) for k in want)


def test_launch_counts_move_by_a_capture_and_back():
    """The counters a replay adds: each change since a snapshot, instance
    counts included, taken back and added again."""
    saved = launches.snapshot()
    before = launches.snapshot()
    tcin.cin_fwd_launches += 2
    tcin.instance_launches["cin_fwd"] = tcin.instance_launches.get("cin_fwd", 0) + 2
    delta = launches.since(before)
    assert delta == {(tcin, "cin_fwd_launches", None): 2,
                     (tcin, "instance_launches", "cin_fwd"): 2}
    launches.add(delta, -1)
    assert launches.snapshot() == before
    launches.add(delta, 3)
    assert tcin.cin_fwd_launches == saved[(tcin, "cin_fwd_launches", None)] + 6
    launches.add(delta, -3)
    assert launches.snapshot() == saved
