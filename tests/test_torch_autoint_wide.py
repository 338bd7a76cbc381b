"""AutoInt at the AutoInt paper's attention width (Song et al., CIKM 2019,
§5.1: 3 interacting layers of 2 heads of d' = 32) on the field-attention
route: the port against the JAX package on the CPU, each under its
``ML_FUNCTION_TPU_FIELD_ATTN=1``, with the JAX parameters copied across by
key path. Each layer's attention has heads wider than 16, which the card
runs on the wide instances (``field_attn_fwd_wide``,
``field_attn_bwd_wide``); on the CPU the port runs their plain versions and
the JAX package its Pallas kernels in interpret mode.

Bars, as in tests/test_torch_interaction.py: logits and ``emb_l2`` at rtol
1e-5 with atol 1e-5·max|ref| (the packages round the matmul inputs to bf16
at the same sites and sum in f32 in other orders), and one step's gradient
of every parameter at 1e-3·max|g|, or one bf16 step where both packages
return bf16 values (the ``bf16_matmul`` weights' gradients, ``ROADMAP.md``
R3); on both matmul paths (``ML_FUNCTION_TPU_F32_MATMUL``, honoured by both).
The cases stay small: 6 sparse fields and 4 dense (7 attention positions
with the dense pseudo-field), dim 4, B 256.
"""

import jax
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_criteo_like as jax_make
from ml_function_tpu.models import get_model as jax_get_model
from ml_function_tpu.train import loop as jloop
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops import attention as tattention
from ml_function_tpu_torch.ops.kernels import field_attention as tfa
from ml_function_tpu_torch.train import loop as tloop

torch.set_num_threads(1)

BATCH = 256
HP = {"n_layers": 3, "num_heads": 2, "head_dim": 32}
DATA = dict(n_rows=BATCH, n_dense=4, n_sparse=6, vocab_size=50, embed_dim=4, seed=3)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol=1e-5):
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


@pytest.fixture(params=["1", "0"], ids=["f32_matmul", "bf16_matmul"])
def case(request, monkeypatch):
    """Both packages on the field-attention route, on one matmul path: the
    JAX model's parameters, logits, emb_l2, loss and gradients, and the
    port's model with those parameters and the port's data."""
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", "1")
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", request.param)
    fs, data = jax_make(**DATA)
    tfs, tdata = make_criteo_like(**DATA)
    assert tfs.fingerprint == fs.fingerprint
    jm = jax_get_model("autoint", fs, **HP)
    params, state = jm.init(jax.random.PRNGKey(0))
    logits, _, aux = jm.apply(params, state, {"dense": data["dense"],
                                              "sparse": data["sparse"]})
    loss, grads = jax.value_and_grad(
        lambda p: jloop.loss_fn(jm, p, state, data, None)[0])(params)
    tm = get_model("autoint", tfs, device="cpu", **HP)
    params_from_numpy(tm, _np_tree(params))
    calls = []
    real = tattention.field_attention
    monkeypatch.setattr(tattention, "field_attention",
                        lambda *a: calls.append(tuple(a[0].shape)) or real(*a))
    return dict(jax=dict(logits=np.asarray(logits), emb_l2=np.asarray(aux["emb_l2"]),
                         loss=float(loss), grads=_np_tree(grads)),
                model=tm, data=tdata, calls=calls)


def test_autoint_wide_takes_the_wide_instances():
    """Each layer's attention shape, (B, 7, 2, 32) here and (4096, 27, 27, 2,
    32) at the Criteo width, goes to the wide instances on the card (the
    wrapper's choice, on meta tensors)."""
    meta = dict(device="meta", dtype=torch.float32)
    for b, l in ((BATCH, 7), (4096, 27)):
        q = torch.empty(b, l, 2, 32, **meta)
        bias = torch.empty(b, l, **meta)
        assert tfa.forward_instance(q, q, q, bias) == "field_attn_fwd_wide"
        assert tfa.backward_instance(q, q, q, bias) == "field_attn_bwd_wide"


def test_autoint_wide_logits_and_emb_l2_match_jax(case):
    tm, tdata = case["model"], case["data"]
    with torch.no_grad():
        got, state, aux = tm({"dense": tdata["dense"], "sparse": tdata["sparse"]})
    assert case["calls"] == [(BATCH, 7, 2, 32)] * 3
    assert got.shape == (BATCH,) and state == {}
    _close(got.numpy(), case["jax"]["logits"])
    _close(aux["emb_l2"].numpy(), case["jax"]["emb_l2"])


def test_autoint_wide_one_step_gradients_match_jax(case):
    tm, tdata = case["model"], case["data"]
    total, _ = tloop.loss_fn(tm, tloop.to_device(tdata, "cpu"))
    total.backward()
    assert case["calls"] == [(BATCH, 7, 2, 32)] * 3
    _close(total.item(), case["jax"]["loss"])
    want = case["jax"]["grads"]
    checked = 0
    for pname, p in tm.named_parameters():
        ref = want
        for k in pname.split("."):
            ref = ref[k]
        if p.grad is None:      # AutoInt's linear table: read by no forward
            assert not np.any(ref), pname
            continue
        _grad_close(p.grad.numpy(), ref)
        checked += 1
    assert checked >= 3 * 4 + 2      # every layer's q, k, v, o and the head
