"""The cold-start machinery: ``emb_override``, ``MetaEmbedding`` (generate,
meta_loss, warm_rows), ``make_meta_batch_pairs`` and
``make_meta_train_step``, the port against the JAX package on the CPU over
DeepFM (the JAX tests' base model: 5 fields of 16 ids, 2 dense, dim 4,
hidden (16,)), with both packages' weights carried across by the bridge.

Bars: with ``ML_FUNCTION_TPU_F32_MATMUL=1`` the generated rows, the
meta-loss and the generator's gradients within 1e-6 of the largest (the
gradient through the inner SGD step, second-order term included, which
moves the gradient by far more than that bar); on the bf16 path 1e-4 for
values and, for the gradients, one bf16 step of max|g| (2^-8) or bf16
neighbours where both are bf16 values (``ROADMAP.md`` R3).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.models.coldstart import MetaEmbedding as JaxMeta
from ml_function_tpu.models.coldstart import make_meta_batch_pairs as jax_pairs
from ml_function_tpu.models.coldstart import make_meta_train_step as jax_meta_step
from ml_function_tpu_torch.bridge import params_from_numpy, params_to_numpy
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.models.coldstart import (MetaEmbedding,
                                                    make_meta_batch_pairs,
                                                    make_meta_train_step)
from ml_function_tpu_torch.train.optimizers import make_optimizer

torch.set_num_threads(1)

DATA_KW = dict(n_rows=256, n_dense=2, n_sparse=5, vocab_size=16, embed_dim=4, seed=3)
HP = {"hidden": (16,)}
B = 64
F32_BAR = 1e-6


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _bf16(x):
    return torch.tensor(np.asarray(x, np.float32)).bfloat16().float().numpy()


def _grad_close(got, want, f32, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    if f32:
        np.testing.assert_allclose(got, want, rtol=F32_BAR, atol=F32_BAR * scale,
                                   err_msg=what)
        return
    err = np.abs(got - want)
    ok = err <= 2.0 ** -8 * scale + 1e-3 * np.abs(want)
    if np.array_equal(_bf16(got), got) and np.array_equal(_bf16(want), want):
        _, e = np.frexp(np.maximum(np.abs(got), np.abs(want)))
        ok |= err <= np.ldexp(1.0, e - 8)
    assert ok.all(), f"{what}: max |err| {err.max()} (scale {scale})"


def _set_f32(f32):
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1" if f32 else "0"


@pytest.fixture(scope="module")
def jax_side():
    """Per matmul mode: DeepFM's and the generator's parameters, the first
    (batch_a, batch_b) pair, the generated rows, the override's logits and
    gradient, the meta-loss and its gradient, and the generator after 3
    Adam meta steps."""
    saved = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    fs, data = jax_make(**DATA_KW)
    target = fs.sparse[0].name
    out = {"pairs": [(a, b) for a, b in jax_pairs(data, fs, target, B, seed=0)]}
    ba, bb = out["pairs"][0]
    try:
        for f32 in (True, False):
            _set_f32(f32)
            model = jax_get_model("deepfm", fs, **HP)
            params, state = model.init(jax.random.PRNGKey(0))
            meta = JaxMeta(fs, target=target)
            gen = meta.init(jax.random.PRNGKey(1))
            rows = meta.generate(gen, params["embedding"], ba)

            def override_loss(vec):
                b = dict(ba, emb_override={target: vec})
                logits, _, _ = model.apply(params, state, b, train=True)
                return jnp.sum(logits ** 2), logits

            (_, ov_logits), ov_grad = jax.value_and_grad(override_loss, has_aux=True)(rows)
            loss, grads = jax.value_and_grad(meta.meta_loss)(gen, model, params, state,
                                                             ba, bb)
            opt = optax.adam(1e-2)
            make_step = jax_meta_step(meta, model, opt)
            g, opt_state = gen, opt.init(gen)
            losses = []
            for _ in range(3):
                g, opt_state, l = make_step(g, opt_state, params, state, ba, bb)
                losses.append(float(l))
            out[f32] = dict(params=_np_tree(params), gen=_np_tree(gen),
                            rows=np.asarray(rows), ov_logits=np.asarray(ov_logits),
                            ov_grad=np.asarray(ov_grad), loss=float(loss),
                            grads=_flat(grads), stepped=_flat(g), losses=losses)
    finally:
        if saved is None:
            os.environ.pop("ML_FUNCTION_TPU_F32_MATMUL", None)
        else:
            os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = saved
    out["fs"], out["target"] = fs, target
    return out


def _port(side, f32):
    fs, data = make_criteo_like(**DATA_KW)
    model = get_model("deepfm", fs, device="cpu", **HP)
    params_from_numpy(model, side[f32]["params"])
    meta = MetaEmbedding(fs, side["target"], device="cpu")
    params_from_numpy(meta, side[f32]["gen"])
    return fs, data, model, meta


def test_meta_batch_pairs_equal_jax(jax_side):
    """The same seed gives the same pairs, batch for batch, and each pair
    holds the same target id row for row."""
    fs, data = make_criteo_like(**DATA_KW)
    target = jax_side["target"]
    got = list(make_meta_batch_pairs(data, fs, target, B, seed=0))
    want = jax_side["pairs"]
    assert len(got) == len(want) > 0
    t = fs.sparse_index(target)
    for (ga, gb), (wa, wb) in zip(got, want):
        for g, w in ((ga, wa), (gb, wb)):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(ga["sparse"][:, t], gb["sparse"][:, t])


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_generate_and_override_match_jax(jax_side, f32, monkeypatch):
    """``generate`` (0.05·tanh of the generator's output, bounded), and
    DeepFM's logits with the rows as ``emb_override`` and their gradient;
    the override takes the table's place: the target field's table rows
    get no gradient from it."""
    side = jax_side
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    fs, _, model, meta = _port(side, f32)
    ba, _ = side["pairs"][0]
    bar = F32_BAR if f32 else 1e-4
    rows = meta.generate(model.embedding, ba)
    _close(rows.detach().numpy(), side[f32]["rows"], bar)
    assert float(rows.detach().abs().max()) <= 0.05
    vec = rows.detach().clone().requires_grad_()
    logits, _, _ = model(dict(ba, emb_override={side["target"]: vec}), train=True)
    (logits ** 2).sum().backward()
    _close(logits.detach().numpy(), side[f32]["ov_logits"], bar)
    _grad_close(vec.grad.numpy(), side[f32]["ov_grad"], f32, "override")
    t = fs.sparse_index(side["target"])
    gids = np.unique(ba["sparse"][:, t] + fs.sparse_offsets()[t])
    assert not model.embedding.table.grad[gids].any()
    assert model.embedding.linear.grad[gids].any()   # the linear is not replaced


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_meta_loss_and_its_gradient_match_jax(jax_side, f32, monkeypatch):
    """The meta-loss and the generator's gradient through the inner step;
    with f32 matmuls the same gradient without the second-order term (the
    inner gradient detached) misses JAX's by far more than the bar."""
    side = jax_side
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    _, _, model, meta = _port(side, f32)
    ba, bb = side["pairs"][0]
    loss = meta.meta_loss(model, ba, bb)
    names = [n for n, _ in meta.named_parameters()]
    grads = torch.autograd.grad(loss, list(meta.parameters()))
    _close(loss.item(), side[f32]["loss"], F32_BAR if f32 else 1e-4)
    assert set(names) == set(side[f32]["grads"])
    for n, g in zip(names, grads):
        _grad_close(g.numpy(), side[f32]["grads"][n], f32, n)
    assert all(p.grad is None for p in model.parameters())
    if f32:
        real = torch.autograd.grad

        def first_order(outputs, inputs, create_graph=False, **kw):
            return real(outputs, inputs, create_graph=False, retain_graph=True)

        monkeypatch.setattr(torch.autograd, "grad", first_order)
        loss1 = meta.meta_loss(model, ba, bb)
        monkeypatch.setattr(torch.autograd, "grad", real)
        g1 = dict(zip(names, real(loss1, list(meta.parameters()))))
        gaps = [np.abs(g1[n].numpy() - side[f32]["grads"][n]).max()
                / np.abs(side[f32]["grads"][n]).max() for n in names]
        assert max(gaps) > 100 * F32_BAR, max(gaps)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_meta_train_step_matches_jax(jax_side, f32, monkeypatch):
    """3 Adam meta steps: the losses and the generator's parameters; the
    base model stays as it was."""
    side = jax_side
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    _, _, model, meta = _port(side, f32)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ba, bb = side["pairs"][0]
    step = make_meta_train_step(meta, model, make_optimizer("adam", 1e-2))
    losses = [step(ba, bb).item() for _ in range(3)]
    _close(losses, side[f32]["losses"], F32_BAR if f32 else 1e-4)
    # Adam normalises each step, so a gradient one bf16 step apart moves a
    # parameter by up to its learning rate: the bf16 path is held at 1e-2·lr
    got = {k.replace("/", "."): v for k, v in _flat(params_to_numpy(meta)).items()}
    for n, want in side[f32]["stepped"].items():
        np.testing.assert_allclose(got[n], want, rtol=0,
                                   atol=1e-6 if f32 else 1e-4, err_msg=n)
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_warm_rows_are_the_generated_rows_without_a_graph(jax_side):
    _, _, model, meta = _port(jax_side, True)
    ba, _ = jax_side["pairs"][0]
    rows = meta.warm_rows(model.embedding, ba)
    assert rows.shape == (B, 4) and not rows.requires_grad
    assert torch.equal(rows, meta.generate(model.embedding, ba).detach())


def test_target_must_be_a_sparse_field_and_the_default_is_the_card():
    fs, _ = make_criteo_like(**DATA_KW)
    with pytest.raises(ValueError, match="not a sparse field"):
        MetaEmbedding(fs, "nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MetaEmbedding(fs, fs.sparse[0].name)


def test_meta_loss_refuses_a_base_model_on_a_kernel():
    """A kernel's backward is not differentiable: over xDeepFM at B 256 with
    CIN (128,) (its layer on the CIN kernel's autograd Function, whose plain
    version runs here) the meta step's inner gradient, taken with
    ``create_graph=True``, raises, rather than give a gradient without the
    second-order term (``once_differentiable`` would not: its error node
    hangs off detached copies, which ``autograd.grad`` over the generator's
    parameters never visits)."""
    fs, data = make_criteo_like(**DATA_KW)
    model = get_model("xdeepfm", fs, device="cpu", cin_hidden=(128,), hidden=(8,))
    meta = MetaEmbedding(fs, fs.sparse[0].name, device="cpu")
    pairs = next(make_meta_batch_pairs(
        {k: np.concatenate([v] * 4) for k, v in data.items()}, fs, fs.sparse[0].name,
        256, seed=0))
    with pytest.raises(RuntimeError, match="cin_layer_t.*no double backward"):
        meta.meta_loss(model, *pairs)
