"""GRU, AUGRU and the fused (AU)GRU recurrence: the port
(ml_function_tpu_torch) against the JAX package on the CPU.

The plain versions of the kernel (``gru_sequence_reference`` and
``gru_sequence_backward_reference``) are held to the JAX ``gru_sequence`` in
interpret mode, as tests/test_gru_kernel.py runs it, at that file's shapes
with ragged masks, with and without attention gates. With the bf16 cast off
on both sides (the JAX ``_mm`` patched as that file does, the port's
``cast_bf16=False``) the two are the same f32 arithmetic in another order:
forward within 1e-5, gradients within 1e-4·max|g|. With the cast on, a sum
taken in another order can round an operand of a later step to the
neighbouring bf16 value: 1e-4 and 1e-3.

The ``GRU``/``AUGRU`` modules take the JAX weights through the bridge and
are held to the JAX modules on both routes: 'scan' (autograd of the step
loop against ``jax.grad`` of ``lax.scan``) and 'pallas' (the kernel's plain
versions against the interpret-mode kernel). With
``ML_FUNCTION_TPU_F32_MATMUL=1`` the bars are 1e-5 and 1e-4, on the bf16
path 1e-4 and 1e-3 (``ROADMAP.md`` R3). The 'pallas' route's recurrent
product rounds in both packages whatever the switch, as the reference's
kernel does.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ml_function_tpu.ops.kernels.gru as jgru_kernel
from ml_function_tpu.ops.kernels.gru import gru_sequence as jax_gru_sequence
from ml_function_tpu.ops.recurrent import AUGRU as JAUGRU
from ml_function_tpu.ops.recurrent import GRU as JGRU
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.ops.kernels import gru as tgru
from ml_function_tpu_torch.ops.recurrent import AUGRU, GRU

torch.set_num_threads(1)

# (B, L, H) of tests/test_gru_kernel.py, then two H that the card's wide
# instances take (F6): the first past the block instances, and DIEN's kd at
# dim 64
SHAPES = [(16, 12, 8), (8, 7, 8), (8, 9, 8), (8, 5, 65), (4, 4, 128)]
BARS = {False: (1e-5, 1e-4), True: (1e-4, 1e-3)}   # cast_bf16 → (fwd, grad)


def _kernel_inputs(shape, seed=0):
    """xw (B, L, 3H), wh, mask (B, L) 0/1 with ragged lengths ≥ 1, att,
    h0 and a cotangent dseq, from numpy."""
    b, l, h = shape
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(b, l, 3 * h)).astype(np.float32)
    wh = (rng.normal(size=(h, 3 * h)) / np.sqrt(h)).astype(np.float32)
    lens = rng.integers(1, l + 1, b)
    mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.float32)
    att = rng.uniform(size=(b, l)).astype(np.float32)
    h0 = (0.5 * rng.normal(size=(b, h))).astype(np.float32)
    dseq = rng.normal(size=(b, l, h)).astype(np.float32)
    return xw, wh, mask, att, h0, dseq


@contextlib.contextmanager
def _jax_cast(cast):
    """The JAX kernel's bf16 cast on or off (tests/test_gru_kernel.py's patch)."""
    orig = jgru_kernel._mm
    jgru_kernel._mm = lambda a, b, dn, c: orig(a, b, dn, cast)
    try:
        yield
    finally:
        jgru_kernel._mm = orig


def _jax_kernel(xw, wh, mask, att, h0, dseq):
    """JAX gru_sequence in its time-major layout: seq and the vjp of dseq,
    back in batch-major."""
    t = lambda a: jnp.transpose(jnp.asarray(a), (1, 0) + tuple(range(2, a.ndim)))  # noqa: E731
    seq_t, vjp = jax.vjp(jax_gru_sequence, t(xw), jnp.asarray(wh), t(mask), t(att),
                         jnp.asarray(h0))
    dxw, dwh, _, da, dh0 = vjp(t(dseq))
    back = lambda a: np.asarray(jnp.transpose(a, (1, 0) + tuple(range(2, a.ndim))))  # noqa: E731
    return back(seq_t), (back(dxw), np.asarray(dwh), back(da), np.asarray(dh0))


@pytest.fixture(scope="module")
def jax_kernel_side():
    out = {}
    for shape in SHAPES:
        xw, wh, mask, att, h0, dseq = _kernel_inputs(shape)
        for use_att in (False, True):
            a = att if use_att else np.ones_like(att)
            for cast in (False, True):
                with _jax_cast(cast):
                    out[shape, use_att, cast] = _jax_kernel(xw, wh, mask, a, h0, dseq)
    return out


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _torch_inputs(shape, use_att):
    xw, wh, mask, att, h0, dseq = (torch.from_numpy(a) for a in _kernel_inputs(shape))
    return xw, wh, mask, att if use_att else torch.ones_like(att), h0, dseq


@pytest.mark.parametrize("cast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("use_att", [False, True], ids=["gru", "augru"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gru_sequence_forward_matches_jax(jax_kernel_side, shape, use_att, cast):
    xw, wh, mask, att, h0, _ = _torch_inputs(shape, use_att)
    want = jax_kernel_side[shape, use_att, cast][0]
    got = tgru.gru_sequence_reference(xw, wh, mask, att, h0, cast_bf16=cast)
    assert got.shape == shape and got.dtype == torch.float32
    _close(got, want, BARS[cast][0])
    if cast:   # the autograd Function on the CPU is the plain version
        tgru.gru_fwd_launches = 0
        np.testing.assert_array_equal(
            tgru.gru_sequence(xw, wh, mask, att, h0).numpy(), got.numpy())
        assert tgru.gru_fwd_launches == 0


@pytest.mark.parametrize("cast", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("use_att", [False, True], ids=["gru", "augru"])
@pytest.mark.parametrize("shape", SHAPES)
def test_gru_sequence_backward_matches_jax(jax_kernel_side, shape, use_att, cast):
    """dxw, dwh, da and dh0 of the written-out backward against the vjp of
    the JAX kernel; with the cast on, also through the autograd Function."""
    xw, wh, mask, att, h0, dseq = _torch_inputs(shape, use_att)
    want = jax_kernel_side[shape, use_att, cast][1]
    seq = tgru.gru_sequence_reference(xw, wh, mask, att, h0, cast_bf16=cast)
    got = tgru.gru_sequence_backward_reference(xw, wh, mask, att, h0, seq, dseq,
                                               cast_bf16=cast)
    for g, w in zip(got, want):
        _close(g, w, BARS[cast][1])
    if cast:
        leaves = [t.clone().requires_grad_() for t in (xw, wh, mask, att, h0)]
        tgru.gru_bwd_launches = 0
        (tgru.gru_sequence(*leaves) * dseq).sum().backward()
        assert leaves[2].grad is None and tgru.gru_bwd_launches == 0
        for leaf, g in zip([leaves[i] for i in (0, 1, 3, 4)], got):
            np.testing.assert_array_equal(leaf.grad.numpy(), g.numpy())


def test_backward_reference_formulas_are_the_gradient():
    """Without the cast and in f64 the written-out formulas equal autograd
    of the plain forward (the mask's 0/1 blend included)."""
    xw, wh, mask, att, h0, dseq = (t.double() for t in _torch_inputs((5, 6, 4), True))
    leaves = [t.clone().requires_grad_() for t in (xw, wh, att, h0)]
    seq = tgru.gru_sequence_reference(leaves[0], leaves[1], mask, leaves[2], leaves[3],
                                      cast_bf16=False)
    seq.backward(dseq)
    got = tgru.gru_sequence_backward_reference(xw, wh, mask, att, h0, seq.detach(), dseq,
                                               cast_bf16=False)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=1e-10, atol=1e-12)


def test_fully_masked_row_keeps_h0():
    xw, wh, mask, att, h0, _ = _torch_inputs((6, 5, 8), True)
    mask[2] = 0.0
    seq = tgru.gru_sequence(xw, wh, mask, att, h0)
    np.testing.assert_array_equal(seq[2].numpy(), h0[2].expand(5, -1).numpy())


# ---------------------------------------------------------------------------
# GRU and AUGRU modules on both routes


MODULE_CASES = [(route, use_att, f32) for route in ("scan", "pallas")
                for use_att in (False, True) for f32 in (True, False)]


def _module_inputs(seed=1):
    rng = np.random.default_rng(seed)
    b, l, d = 8, 7, 5
    x = rng.normal(size=(b, l, d)).astype(np.float32)
    lens = rng.integers(1, l + 1, b)
    mask = np.arange(l)[None, :] < lens[:, None]
    att = rng.uniform(size=(b, l)).astype(np.float32)
    return x, mask, att


@contextlib.contextmanager
def _f32_matmul(on):
    old = os.environ.get("ML_FUNCTION_TPU_F32_MATMUL")
    os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["ML_FUNCTION_TPU_F32_MATMUL"]
        else:
            os.environ["ML_FUNCTION_TPU_F32_MATMUL"] = old


def _loss_jax(cell, params, x, mask, att):
    kw = {} if att is None else {"att_scores": att}
    seq, last = cell(params, x, mask, **kw)
    return jnp.sum(jnp.sin(seq)) + jnp.sum(last * last), (seq, last)


@pytest.fixture(scope="module")
def jax_module_side():
    """Per case: the JAX params, seq, last and the gradients of
    sum(sin(seq)) + sum(last²) by params, x and att."""
    x, mask, att = _module_inputs()
    params = jax.tree_util.tree_map(np.asarray, JGRU(5, 8).init(jax.random.PRNGKey(1)))
    out = {}
    for route, use_att, f32 in MODULE_CASES:
        cell = JGRU(5, 8, kernel=route)
        with _f32_matmul(f32):
            (_, (seq, last)), grads = jax.value_and_grad(
                lambda p, xx, aa: _loss_jax(cell, p, xx, jnp.asarray(mask),
                                            aa if use_att else None),
                argnums=(0, 1, 2), has_aux=True)(params, jnp.asarray(x), jnp.asarray(att))
        out[route, use_att, f32] = (np.asarray(seq), np.asarray(last),
                                    jax.tree_util.tree_map(np.asarray, grads))
    return params, out


@pytest.mark.parametrize("route,use_att,f32", MODULE_CASES,
                         ids=[f"{r}-{'augru' if a else 'gru'}-{'f32' if f else 'bf16'}"
                              for r, a, f in MODULE_CASES])
def test_gru_module_matches_jax(jax_module_side, route, use_att, f32, monkeypatch):
    params, side = jax_module_side
    want_seq, want_last, (gp, gx, ga) = side[route, use_att, f32]
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1" if f32 else "0")
    fwd_bar, grad_bar = BARS[not f32]
    x, mask, att = _module_inputs()
    cell = (AUGRU if use_att else GRU)(5, 8, kernel=route)
    params_from_numpy(cell, params)
    tx = torch.from_numpy(x).requires_grad_()
    ta = torch.from_numpy(att).requires_grad_()
    kw = {"att_scores": ta} if use_att else {}
    seq, last = cell(tx, torch.from_numpy(mask), **kw)
    (torch.sin(seq).sum() + (last * last).sum()).backward()
    _close(seq.detach(), want_seq, fwd_bar)
    _close(last.detach(), want_last, fwd_bar)
    for name in ("wx", "wh", "b"):
        _close(getattr(cell, name).grad, gp[name], grad_bar)
    _close(tx.grad, gx, grad_bar)
    if use_att:
        _close(ta.grad, ga, grad_bar)


def test_augru_parameters_are_the_reference_layout():
    params = JAUGRU(6, 4).init(jax.random.PRNGKey(0))
    got = {n: tuple(p.shape) for n, p in AUGRU(6, 4).named_parameters()}
    assert got == {k: tuple(v.shape) for k, v in params.items()}
    assert got == {"wx": (6, 12), "wh": (4, 12), "b": (12,)}


def test_unknown_kernel_raises():
    with pytest.raises(ValueError, match="bogus"):
        GRU(4, 4, kernel="bogus")
    cell = AUGRU(4, 4)
    cell.kernel = "bogus"
    with pytest.raises(ValueError, match="bogus"):
        cell(torch.zeros(2, 3, 4), torch.ones(2, 3, dtype=torch.bool),
             att_scores=torch.ones(2, 3))
