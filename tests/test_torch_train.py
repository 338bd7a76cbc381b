"""Training parity: the port's loss, gradients, optimizers, metrics and fit
against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the JAX
parameters cross by key path (``bridge.params_from_numpy``). Tolerances:

- gradients of whole models: 1e-3·max|g| per tensor. Both packages round
  at the same bf16 sites; what differs is the f32 summation order, and the
  embedding gradient's scatter-add order, which moves a table row's sum by
  an ulp or so of its largest term;
- optimizer states after 3 steps on fixed gradients: rtol 1e-5. The update
  rules are the same formulas in f32; Adam's first step is about lr·sign(g),
  so model gradients that differ in rounding near 0 could flip an element
  by 2·lr, hence fixed gradients;
- metrics: AUC and logloss to 1e-5 (f32 sums in another order);
- fit: the held-out AUC within 0.01 of JAX's, and above the measured value
  less 0.06, the margin tests/test_models_learn_all.py uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.train import loop as jloop
from ml_function_tpu.train import metrics as jmetrics
from ml_function_tpu.train import optimizers as joptim
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops.kernels import cin as tcin
from ml_function_tpu_torch.train import loop as tloop
from ml_function_tpu_torch.train import metrics as tmetrics
from ml_function_tpu_torch.train import optimizers as toptim

torch.set_num_threads(1)

LEARN_KW = dict(n_rows=6000, n_dense=4, n_sparse=6, vocab_size=40,
                embed_dim=8, seed=11)
FIT_KW = dict(epochs=2, batch_size=256, learning_rate=5e-3, seed=0)
# held-out AUC of the JAX package on LEARN_KW data with FIT_KW (measured
# 0.7447 and 0.7511) less 0.06
FIT_FLOORS = {"xdeepfm": 0.68, "deepfm": 0.69}
FIT_HP = {"xdeepfm": {"cin_hidden": (128, 128), "hidden": (32, 16)},
          "deepfm": {"hidden": (32, 16)}}


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


def _jax_init(jm, seed=0):
    """The parameters the JAX ``fit`` starts from at ``seed``."""
    init_rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    params, state = jm.init(init_rng)
    return _np_tree(params), state


@pytest.fixture(scope="module")
def jax_fits():
    """The JAX side of the fit tests, run once for the module."""
    fs, data = jax_make(**LEARN_KW)
    tr, te = jloop.train_test_split(data, 0.25, seed=1)
    out = {}
    for name, hp in FIT_HP.items():
        jm = jax_get_model(name, fs, **hp)
        _, res = jloop.fit(jm, tr, eval_data=te, **FIT_KW)
        out[name] = (_jax_init(jm), res)
    return out


# ---------------------------------------------------------------------------
# loss and gradients


@pytest.mark.parametrize("name,hp,batch", [
    ("deepfm", {"hidden": (16, 8)}, 256),
    ("xdeepfm", {"cin_hidden": (128, 128), "hidden": (16, 8)}, 256),  # CIN kernel route
    ("xdeepfm", {"cin_hidden": (128,), "hidden": (16, 8)}, 96),       # CIN einsum route
])
def test_model_gradients_match_jax(name, hp, batch):
    fs, data = jax_make(n_rows=batch, n_dense=4, n_sparse=6, vocab_size=50,
                        embed_dim=4, seed=1)
    w = np.ones(batch, np.float32)
    w[-40:] = 0.0                     # a padded tail the loss must mask out
    data["weight"] = w
    jm = jax_get_model(name, fs, **hp)
    params, state = jm.init(jax.random.PRNGKey(0))

    def jloss(p):
        total, (_, _, _, bce) = jloop.loss_fn(jm, p, state, data, None)
        return total, bce

    (want_loss, want_bce), want = jax.value_and_grad(jloss, has_aux=True)(params)

    tfs, tdata = make_criteo_like(n_rows=batch, n_dense=4, n_sparse=6,
                                  vocab_size=50, embed_dim=4, seed=1)
    tdata["weight"] = w
    tm = get_model(name, tfs, device="cpu", **hp)
    params_from_numpy(tm, _np_tree(params))
    tcin.cin_bwd_launches = 0
    total, (_, _, aux, bce) = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    assert tcin.cin_bwd_launches == 0
    _close(total.item(), want_loss, 1e-5)
    _close(bce.item(), want_bce, 1e-5)
    assert set(aux) == {"emb_l2"}
    for pname, p in tm.named_parameters():
        _close(p.grad.numpy(), _at(want, pname), 1e-3)


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("f32,tol", [("1", 1e-4), ("0", 1e-3)])
def test_autoint_adam_step_loss_and_gradients_match_jax(flag, f32, tol,
                                                        monkeypatch):
    """One Adam step of AutoInt on the small-L route (flag 0) and through
    the field-attention Function (flag 1): its loss and the gradients it
    steps on against jax.grad. With ``ML_FUNCTION_TPU_F32_MATMUL=1`` they
    agree within 1e-4·max|g|. With the bf16 sites on, both packages return
    each weight's gradient rounded to bf16, so an element whose f32 sum
    differs in its last bits lands one bf16 step (2^-8 relative) away:
    1e-3·max|g|, as for the other models. The unread ``linear`` table gets
    no gradient here and zeros in JAX."""
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", flag)
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", f32)
    batch = 256
    fs, data = jax_make(n_rows=batch, n_dense=4, n_sparse=6, vocab_size=50,
                        embed_dim=4, seed=1)
    w = np.ones(batch, np.float32)
    w[-40:] = 0.0
    data["weight"] = w
    jm = jax_get_model("autoint", fs, n_layers=2)
    params, state = jm.init(jax.random.PRNGKey(0))

    def jloss(p):
        return jloop.loss_fn(jm, p, state, data, None)[0]

    want_loss, want = jax.value_and_grad(jloss)(params)

    tfs, tdata = make_criteo_like(n_rows=batch, n_dense=4, n_sparse=6,
                                  vocab_size=50, embed_dim=4, seed=1)
    tdata["weight"] = w
    tm = get_model("autoint", tfs, device="cpu", n_layers=2)
    params_from_numpy(tm, _np_tree(params))
    out = tloop.make_train_step(tm, toptim.make_optimizer("adam", 1e-3).init(tm))(
        tdata)
    _close(out["loss"].item(), want_loss, 1e-5)
    for pname, p in tm.named_parameters():
        ref = _at(want, pname)
        got = np.zeros_like(ref) if p.grad is None else p.grad.numpy()
        _close(got, ref, tol)
    assert tm.embedding.linear.grad is None


def test_loss_masks_the_padded_tail():
    fs, data = make_criteo_like(n_rows=64, n_dense=2, n_sparse=3,
                                vocab_size=10, embed_dim=4, seed=2)
    tm = get_model("deepfm", fs, device="cpu", hidden=(8,))
    batch = tloop.to_device(data, "cpu")
    batch["weight"] = torch.ones(64)
    batch["weight"][32:] = 0
    _, (logits, _, _, bce) = tloop.loss_fn(tm, batch)
    per_ex = tmetrics.bce_with_logits(logits[:32], batch["label"][:32])
    assert bce.item() == pytest.approx(per_ex.mean().item(), rel=1e-6)


# ---------------------------------------------------------------------------
# optimizers and schedules


def _fixed_grads(seed=7):
    rng = np.random.default_rng(seed)
    shapes = {"embedding": {"table": (12, 4), "linear": (12, 1)},
              "mlp": {"w": (5, 3), "b": (3,)}, "bias": ()}
    p0 = jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree_util.tree_map(
        lambda a: rng.normal(0, 1, a.shape).astype(np.float32), p0)
        for _ in range(3)]
    return p0, grads


def _run_optax(opt, p0, grads, lr_after_first=None):
    params = jax.tree_util.tree_map(jnp.asarray, p0)
    state = opt.init(params)
    for i, g in enumerate(grads):
        if i == 1 and lr_after_first is not None:
            state = joptim.set_learning_rate(state, lr_after_first)
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    state, params)
        params = optax.apply_updates(params, updates)
    return _np_tree(params)


def _run_port(spec, p0, grads, lr_after_first=None, skip_grad=()):
    names = ["embedding.table", "embedding.linear", "mlp.w", "mlp.b", "bias"]
    named = [(n, torch.nn.Parameter(torch.from_numpy(_at(p0, n).copy())))
             for n in names]
    opt = spec.init(named)
    for i, g in enumerate(grads):
        if i == 1 and lr_after_first is not None:
            toptim.set_learning_rate(opt, lr_after_first)
        for n, p in named:
            p.grad = None if n in skip_grad else torch.from_numpy(_at(g, n).copy())
        opt.step()
    return {n: p.detach().numpy() for n, p in named}


@pytest.mark.parametrize("name,kw", [
    ("adam", {}), ("adagrad", {}), ("sgd", {}), ("sgd", {"momentum": 0.9}),
    ("sgd", {"momentum": 0.9, "nesterov": True}), ("adamw", {}),
    ("adamw", {"weight_decay": 0.1}),
    ("ftrl", {"lambda1": 0.05, "lambda2": 0.1}),
    ("adam", {"schedule": "cosine", "decay_steps": 2}),
    ("sgd", {"schedule": "exponential", "transition_steps": 1, "decay_rate": 0.5}),
    ("adagrad", {"schedule": "warmup_cosine", "warmup_steps": 1,
                 "decay_steps": 4, "end_lr_frac": 0.1}),
])
def test_optimizer_matches_optax_after_three_steps(name, kw):
    p0, grads = _fixed_grads()
    lr = 0.05
    want = _run_optax(joptim.make_optimizer(name, lr, **kw), p0, grads)
    got = _run_port(toptim.make_optimizer(name, lr, **kw), p0, grads)
    for n, v in got.items():
        _close(v, _at(want, n), 1e-5)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_in_place_update_is_optax_expression_bitwise(weight_decay):
    """Adam's update runs in place on its moments and two scratch tensors;
    it gives the bits of optax's expression written out, one rounding an
    operation, over three steps. The bias corrections are optax's too:
    1 − b**count in f32, the count an int32 tensor."""
    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn(64, 8, generator=gen)
    grads = [torch.randn(64, 8, generator=gen) for _ in range(3)]
    b1, b2, eps, lr = 0.9, 0.999, 1e-8, 0.05
    want, mu, nu = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
    for k, g in enumerate(grads, start=1):
        count = torch.tensor(k, dtype=torch.int32)
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        u = (mu / (1 - b1 ** count)) / (torch.sqrt(nu / (1 - b2 ** count) + 0.0) + eps)
        if weight_decay:
            u = u + weight_decay * want
        want = want + u * -lr
    p = torch.nn.Parameter(p0.clone())
    opt = toptim.Adam([p], lr, weight_decay=weight_decay)
    for g in grads:
        p.grad = g.clone()
        opt.step()
    assert torch.equal(p.detach(), want)


def test_a_parameter_without_gradient_steps_as_a_zero_gradient():
    p0, grads = _fixed_grads()
    zeroed = [jax.tree_util.tree_map(lambda a: a, g) for g in grads]
    for g in zeroed:
        g["mlp"]["b"] = np.zeros_like(g["mlp"]["b"])
    want = _run_optax(joptim.make_optimizer("adamw", 0.05), p0, zeroed)
    got = _run_port(toptim.make_optimizer("adamw", 0.05), p0, grads,
                    skip_grad=("mlp.b",))
    for n, v in got.items():
        _close(v, _at(want, n), 1e-5)


def test_injected_learning_rate_matches_optax():
    p0, grads = _fixed_grads()
    want = _run_optax(joptim.make_optimizer("adam", 0.05, inject_lr=True),
                      p0, grads, lr_after_first=0.01)
    got = _run_port(toptim.make_optimizer("adam", 0.05, inject_lr=True),
                    p0, grads, lr_after_first=0.01)
    for n, v in got.items():
        _close(v, _at(want, n), 1e-5)
    opt = toptim.make_optimizer("adam", 0.05).init(
        [("w", torch.nn.Parameter(torch.zeros(2)))])
    with pytest.raises(ValueError, match="inject_lr"):
        toptim.set_learning_rate(opt, 0.01)
    with pytest.raises(ValueError, match="ONE"):
        toptim.make_optimizer("adam", 0.05, schedule="cosine", inject_lr=True)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.make_optimizer("lamb")


def test_embedding_partitioned_matches_optax():
    p0, grads = _fixed_grads()
    want = _run_optax(joptim.embedding_partitioned(optax.adam(0.01)), p0,
                      grads)
    got = _run_port(toptim.embedding_partitioned(
        toptim.make_optimizer("adam", 0.01)), p0, grads)
    for n, v in got.items():
        _close(v, _at(want, n), 1e-5)
    assert [toptim._is_table(n) for n in got] == [True, True, False, False,
                                                   False]


@pytest.mark.parametrize("name,kw", [
    ("constant", {}), ("cosine", {"decay_steps": 10, "end_lr_frac": 0.1}),
    ("exponential", {"transition_steps": 3, "decay_rate": 0.5}),
    ("warmup_cosine", {"warmup_steps": 3, "decay_steps": 10}),
    ("warmup_cosine", {"warmup_steps": 0, "decay_steps": 10,
                       "end_lr_frac": 0.2}),
])
def test_lr_schedules_match_optax(name, kw):
    want = joptim.make_lr_schedule(name, 0.1, **kw)
    got = toptim.make_lr_schedule(name, 0.1, **kw)
    for count in (0, 1, 2, 3, 5, 9, 10, 14):
        w = want(jnp.asarray(count)) if callable(want) else want
        g = got(count) if callable(got) else got
        assert g == pytest.approx(float(w), rel=1e-6, abs=1e-9), count


# ---------------------------------------------------------------------------
# metrics


def test_bce_gradient_at_a_zero_logit_is_the_reference_one():
    """At logits of exactly 0 (and beside them) the per-example BCE's
    gradient is the JAX package's: −y at 0, not the derivative σ(0) − y."""
    logits = np.array([0.0, 0.0, -0.0, 1.5, -2.0], np.float32)
    labels = np.array([0.0, 1.0, 1.0, 1.0, 0.0], np.float32)
    want = jax.grad(lambda x: jnp.sum(jmetrics.bce_with_logits(
        x, jnp.asarray(labels))))(jnp.asarray(logits))
    x = torch.tensor(logits, requires_grad=True)
    tmetrics.bce_with_logits(x, torch.from_numpy(labels)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(x.grad.numpy()[:3], -labels[:3])


def test_streaming_metrics_match_jax():
    rng = np.random.default_rng(9)
    jm_state = jmetrics.init_metrics()
    tm_state = tmetrics.init_metrics()
    for _ in range(2):
        logits = rng.normal(0, 2, 512).astype(np.float32)
        labels = (rng.uniform(size=512) < 0.3).astype(np.float32)
        w = (rng.uniform(size=512) < 0.9).astype(np.float32)
        jm_state = jmetrics.update_metrics(jm_state, jnp.asarray(logits),
                                           jnp.asarray(labels), jnp.asarray(w))
        tm_state = tmetrics.update_metrics(tm_state, torch.from_numpy(logits),
                                           torch.from_numpy(labels),
                                           torch.from_numpy(w))
        np.testing.assert_allclose(
            tmetrics.bce_with_logits(torch.from_numpy(logits),
                                     torch.from_numpy(labels)).numpy(),
            jmetrics.bce_with_logits(jnp.asarray(logits), jnp.asarray(labels)),
            rtol=1e-6, atol=1e-7)
    # a score on a bin edge may land one bin over (sigmoid differs by an ulp)
    for k in ("pos_hist", "neg_hist"):
        diff = np.abs(tm_state[k].numpy() - np.asarray(jm_state[k]))
        assert diff.sum() <= 2.0 and tm_state[k].sum() == float(jm_state[k].sum())
    merged = tmetrics.merge_metrics(tm_state, tm_state)
    assert float(merged["count"]) == 2 * float(tm_state["count"])
    want = jmetrics.metrics_summary(jm_state)
    got = tmetrics.metrics_summary(tm_state)
    assert got["count"] == want["count"]
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-5)
    assert got["logloss"] == pytest.approx(want["logloss"], rel=1e-5)
    assert tmetrics.metrics_summary(tmetrics.init_metrics())["auc"] == 0.5


def test_host_metrics_are_the_reference_functions():
    rng = np.random.default_rng(10)
    y = (rng.uniform(size=300) < 0.4).astype(np.float32)
    p = rng.uniform(size=300)
    g = rng.integers(0, 20, 300)
    assert tmetrics.gauc(y, p, g) == jmetrics.gauc(y, p, g)
    assert tmetrics.calibration(y, p) == jmetrics.calibration(y, p)
    u = rng.normal(size=(7, 3, 4))
    v = rng.normal(size=(30, 4))
    t = rng.integers(0, 30, 7)
    assert (tmetrics.retrieval_metrics(u, v, t)
            == jmetrics.retrieval_metrics(u, v, t))
    assert (tmetrics.retrieval_metrics(u[:, 0], v, t, ks=(5,))
            == jmetrics.retrieval_metrics(u[:, 0], v, t, ks=(5,)))


# ---------------------------------------------------------------------------
# the loop


def test_train_test_split_matches_jax():
    _, data = make_criteo_like(n_rows=101, n_dense=2, n_sparse=3,
                               vocab_size=10, seed=3)
    data["seq"] = {"s": np.arange(101 * 2).reshape(101, 2)}
    got = tloop.train_test_split(data, 0.3, seed=4)
    want = jloop.train_test_split(data, 0.3, seed=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["sparse"], b["sparse"])
        np.testing.assert_array_equal(a["seq"]["s"], b["seq"]["s"])


@pytest.mark.parametrize("name", sorted(FIT_HP))
def test_fit_matches_jax(jax_fits, name):
    (params, state), want = jax_fits[name]
    fs, data = make_criteo_like(**LEARN_KW)
    tr, te = tloop.train_test_split(data, 0.25, seed=1)
    tm = get_model(name, fs, device="cpu", **FIT_HP[name])
    ts, got = tloop.fit(tm, tr, eval_data=te, init_params=(params, state),
                        **FIT_KW)
    assert got.steps == want.steps == ts.step == ts.optimizer.count
    assert got.train_metrics["count"] == want.train_metrics["count"]
    assert got.eval_metrics["count"] == want.eval_metrics["count"]
    assert abs(got.eval_metrics["auc"] - want.eval_metrics["auc"]) < 0.01
    assert want.eval_metrics["auc"] > FIT_FLOORS[name]
    assert got.eval_metrics["auc"] > FIT_FLOORS[name]
    assert got.examples_per_sec > 0


def _small_fit_data():
    return make_criteo_like(n_rows=1100, n_dense=2, n_sparse=4,
                            vocab_size=11, embed_dim=4, seed=13)


def test_fit_steps_per_call_matches_unchained():
    """1100 rows at B 128: 8 full batches and a padded tail per epoch."""
    fs, data = _small_fit_data()
    results = []
    for spc in (1, 2):
        tm = get_model("deepfm", fs, device="cpu", hidden=(8,))
        _, r = tloop.fit(tm, data, epochs=2, batch_size=128,
                         learning_rate=5e-3, eval_data=data, seed=5,
                         steps_per_call=spc)
        results.append(r)
    r1, r2 = results
    assert r1.steps == r2.steps == 18
    assert r1.train_metrics == r2.train_metrics
    assert r1.train_metrics["count"] == 2 * 1100
    assert r1.eval_metrics == r2.eval_metrics


def test_fit_patience_plateau_and_restore_best():
    fs, data = _small_fit_data()
    tr, te = tloop.train_test_split(data, 0.3, seed=0)
    tm = get_model("deepfm", fs, device="cpu", hidden=(8,))
    ts, r = tloop.fit(tm, tr, epochs=8, batch_size=128, learning_rate=0.2,
                      eval_data=te, seed=0, eval_every=3, patience=3,
                      plateau={"factor": 0.5, "patience": 1, "min_lr": 0.01})
    aucs = r.history.series("auc")
    lrs = r.history.series("lr")
    assert r.stopped_early and r.steps < 8 * 6
    assert len(aucs) == r.steps // 3
    assert lrs[0] == 0.2 and lrs[-1] < 0.2          # the plateau fired
    assert toptim.get_learning_rate(ts.optimizer) == lrs[-1]
    assert all(b <= a for a, b in zip(lrs, lrs[1:]))
    assert r.best_step == 3 * (int(np.argmax(aucs)) + 1)
    # the returned model is the best eval's, evaluated again
    assert r.eval_metrics["auc"] == max(aucs)


def test_fit_refuses_what_it_cannot_do():
    fs, data = _small_fit_data()
    tm = get_model("deepfm", fs, device="cpu", hidden=(8,))
    with pytest.raises(ValueError, match="inject_lr"):
        tloop.fit(tm, data, eval_data=data, plateau={"factor": 0.5},
                  optimizer=toptim.make_optimizer("adam", 1e-3))
    with pytest.raises(ValueError, match="steps_per_call"):
        tloop.fit(tm, data, eval_data=data, patience=2, steps_per_call=2)
    with pytest.raises(ValueError, match="eval_data"):
        tloop.fit(tm, data, patience=2)


def test_evaluate_adds_gauc_and_calibration_with_a_group_column():
    fs, data = _small_fit_data()
    data["group"] = np.arange(1100) % 17
    tm = get_model("deepfm", fs, device="cpu", hidden=(8,))
    summ = tloop.evaluate(tm, data, batch_size=256)
    assert summ["count"] == 1100
    assert {"gauc", "gauc_groups", "ratio", "ece"} <= set(summ)
    with torch.no_grad():
        logits, _, _ = tm(data)
    p = torch.sigmoid(logits).numpy()
    assert summ["gauc"] == pytest.approx(
        tmetrics.gauc(data["label"], p, data["group"])[0], abs=1e-6)
