"""Field attention and MultiHeadAttention parity: the port
(ml_function_tpu_torch) against the JAX package on the CPU.

On the CPU the port's ``field_attention`` runs its plain versions, forward
and backward; the JAX one runs the Pallas kernels in interpret mode, as
tests/test_field_attention.py does, at that file's three shapes, at
AutoInt's (B 256, L 27, H 2, Dh 16), at two shapes past 32 positions and at
three past Dh 16 or H 8. Both are f32 throughout and differ only
in the order of f32 sums: the forward is held to rtol 1e-5/atol 1e-6 and
dQ, dK, dV to ``jax.grad`` within rtol 1e-4/atol 1e-5, the tolerances of
tests/test_field_attention.py.

``MultiHeadAttention`` takes the JAX weights through the bridge and is held
to rtol 1e-5 with atol 1e-5·max|ref| on each route the CPU reaches, with
``ML_FUNCTION_TPU_F32_MATMUL=1`` (honoured by both packages) so that the
projections multiply in f32: the point is the routes' arithmetic. With the
bf16 sites on, an attention output that the two packages sum in another
order can round to the neighbouring bf16 value before the output
projection (2^-8 relative), which shows past 1e-5 in a few of a thousand
elements; the AutoInt tests in tests/test_torch_models.py hold the bf16
path end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.ops.attention import MultiHeadAttention as JMHA
from ml_function_tpu.ops.attention import attention_mask_bias as jax_mask_bias
from ml_function_tpu.ops.kernels.field_attention import \
    field_attention as jax_field_attention
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.ops import attention as tattention
from ml_function_tpu_torch.ops.attention import (MultiHeadAttention,
                                                 attention_mask_bias)
from ml_function_tpu_torch.ops.kernels import field_attention as tfa

torch.set_num_threads(1)

# tests/test_field_attention.py's three shapes, AutoInt's, then past 32
# positions, where the port's L-64 instances take over on the card: DMIN's
# refiner (L 64, H 2, Dh 8) and Lq ≠ Lk; then past Dh 16 or H 8, where the
# wide instances take over: AutoInt at 2 heads of 32, the gate's Dh-64
# edge and H 10
SHAPES = [(37, 5, 7, 2, 4), (130, 27, 27, 2, 16), (64, 1, 9, 3, 8),
          (256, 27, 27, 2, 16), (9, 64, 64, 2, 8), (6, 40, 48, 3, 16),
          (130, 27, 27, 2, 32), (9, 64, 64, 2, 64), (33, 12, 12, 10, 8)]


def _inputs(shape, seed=0):
    b, lq, lk, h, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, lk, h, hd)).astype(np.float32)
    v = rng.normal(size=(b, lk, h, hd)).astype(np.float32)
    mask = rng.uniform(size=(b, lk)) > 0.3
    mask[:, 0] = True
    bias = np.where(mask, 0.0, -1e9).astype(np.float32)
    return q, k, v, bias, float(1.0 / np.sqrt(hd))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's interpret-mode kernel at each shape: the output, and dQ, dK, dV
    of sum(sin(o))."""
    out = {}
    for shape in SHAPES:
        q, k, v, bias, scale = _inputs(shape)
        jb = jnp.asarray(bias)
        o = jax_field_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                jb, scale)
        grads = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(
            jax_field_attention(q, k, v, jb, scale))), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out[shape] = (np.asarray(o), [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("shape", SHAPES)
def test_field_attention_forward_matches_jax(jax_side, shape):
    q, k, v, bias, scale = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in _inputs(shape))
    want = jax_side[shape][0]
    tfa.field_attn_fwd_launches = 0
    for fn in (tfa.field_attention_reference, tfa.field_attention):
        got = fn(q, k, v, bias, scale)
        assert got.shape == q.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert tfa.field_attn_fwd_launches == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_field_attention_gradients_match_jax(jax_side, shape):
    """Through the autograd Function, whose CPU backward is
    ``field_attention_backward_reference``, and by that function itself."""
    q, k, v, bias, scale = _inputs(shape)
    want = jax_side[shape][1]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tbias = torch.from_numpy(bias).requires_grad_()
    tfa.field_attn_bwd_launches = 0
    out = tfa.field_attention(*leaves, tbias, scale)
    torch.sin(out).sum().backward()
    assert tbias.grad is None and tfa.field_attn_bwd_launches == 0
    direct = tfa.field_attention_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v, bias)),
        torch.cos(out.detach()), scale)
    for leaf, d, w in zip(leaves, direct, want):
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(d.numpy(), w, rtol=1e-4, atol=1e-5)


def test_backward_reference_formulas_are_the_gradient():
    """In f64 the written-out formulas equal autograd of the plain forward."""
    q, k, v, bias, scale = (torch.from_numpy(a).double()
                            if isinstance(a, np.ndarray) else a
                            for a in _inputs((5, 3, 6, 2, 4), seed=3))
    do = torch.from_numpy(np.random.default_rng(4).normal(
        size=q.shape)).double()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.field_attention_reference(*leaves, bias, scale).backward(do)
    got = tfa.field_attention_backward_reference(q, k, v, bias, do, scale)
    for g, leaf in zip(got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=1e-10,
                                   atol=1e-12)


def test_fully_masked_row_gets_uniform_weights():
    """A query whose keys are all masked takes the mean of v over all Lk
    keys: the reference's dense semantics (every logit rounds to -1e9)."""
    q, k, v, bias, scale = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in _inputs((4, 3, 9, 2, 8), seed=5))
    bias[1] = -1e9
    out = tfa.field_attention(q, k, v, bias, scale)
    want = v[1].mean(dim=0, keepdim=True).expand(3, -1, -1)
    np.testing.assert_allclose(out[1].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    jax_out = jax_field_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v, bias)),
                                  scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax_out), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# MultiHeadAttention


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# (route, lq, lk, options): lq·lk ≤ 4096 takes the flag or small-L route,
# above it the einsum route; the flag route gives way to small-L with an
# extra_bias or a causal mask, as in the reference; flash='always', or
# 'auto' at Lk ≥ 512, takes the flash route before all of them
MHA_CASES = [
    ("flag", 7, 7, {}),
    ("flag", 7, 7, {"mask": True}),
    ("flag", 5, 9, {"mask": True, "cross": True}),
    ("flag", 27, 27, {"head_dim": 16}),
    ("small", 7, 7, {}),
    ("small", 7, 7, {"mask": True}),
    ("small", 7, 7, {"extra_bias": True}),
    ("small", 7, 7, {"causal": True, "mask": True}),
    ("small", 5, 9, {"mask": True, "cross": True}),
    ("flag_to_small", 7, 7, {"extra_bias": True}),
    ("flag_to_small", 7, 7, {"causal": True}),
    ("einsum", 70, 70, {}),
    ("einsum", 70, 70, {"mask": True, "extra_bias": True}),
    ("einsum", 70, 70, {"causal": True}),
    # flash: forced at small L, and taken by 'auto' at a key length of 512
    ("flash", 9, 9, {"flash": "always"}),
    ("flash", 9, 9, {"flash": "always", "causal": True, "mask": True}),
    ("flash", 3, 512, {"mask": True, "cross": True}),
]


@pytest.mark.parametrize("route,lq,lk,opts", MHA_CASES,
                         ids=[f"{r}-{lq}x{lk}-" + "-".join(sorted(o)) for r, lq, lk, o
                              in MHA_CASES])
def test_multi_head_attention_matches_jax(route, lq, lk, opts, monkeypatch):
    monkeypatch.setenv("ML_FUNCTION_TPU_F32_MATMUL", "1")
    flag = route in ("flag", "flag_to_small")
    flash = opts.get("flash", "auto")
    if flag:
        monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", "1")
    else:
        monkeypatch.delenv("ML_FUNCTION_TPU_FIELD_ATTN", raising=False)
    b, dim = 6, 8
    hd = opts.get("head_dim")
    causal = bool(opts.get("causal"))
    rng = np.random.default_rng(lq * 100 + lk)
    x = rng.normal(size=(b, lq, dim)).astype(np.float32)
    kv = rng.normal(size=(b, lk, dim)).astype(np.float32) if opts.get("cross") else None
    mask = None
    if opts.get("mask"):
        mask = rng.uniform(size=(b, lk)) > 0.4
        mask[:, 0] = True
    extra = (rng.normal(size=(b, lq, lk)).astype(np.float32)
             if opts.get("extra_bias") else None)

    jm = JMHA(dim, 2, hd, causal=causal, flash=flash)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    want = jm(params, jnp.asarray(x), None if kv is None else jnp.asarray(kv),
              None if mask is None else jnp.asarray(mask),
              None if extra is None else jnp.asarray(extra))

    tm = MultiHeadAttention(dim, 2, hd, causal=causal, flash=flash)
    params_from_numpy(tm, params)
    calls, flash_calls = [], []
    real = tattention.field_attention
    monkeypatch.setattr(tattention, "field_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    real_flash = tattention.flash_attention
    monkeypatch.setattr(tattention, "flash_attention", lambda *a, **kw:
                        flash_calls.append(a[0].shape) or real_flash(*a, **kw))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), None if kv is None else torch.from_numpy(kv),
                 None if mask is None else torch.from_numpy(mask),
                 None if extra is None else torch.from_numpy(extra))
    assert bool(calls) == (route == "flag")
    assert flash_calls == ([(b, 2, lq, hd or dim // 2)] if route == "flash" else [])
    assert got.shape == (b, lq, dim)
    _close(got.numpy(), want)


def test_multi_head_attention_parameter_layout_is_the_reference_layout():
    jm = JMHA(8, 2, 16)
    params = jm.init(jax.random.PRNGKey(0))
    tm = MultiHeadAttention(8, 2, 16)
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {n.replace(".", "/"): tuple(p.shape) for n, p in tm.named_parameters()}
    assert got == want
    assert got["q"] == (8, 32) and got["o"] == (32, 8)


def test_attention_mask_bias_matches_jax():
    mask = np.random.default_rng(0).uniform(size=(3, 4, 5)) > 0.5
    got = attention_mask_bias(torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (3, 4, 1, 5)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_mask_bias(jnp.asarray(mask))))
