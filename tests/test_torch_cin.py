"""CIN parity: the port (ml_function_tpu_torch) against the JAX package.

On the CPU the port's ``cin_layer_t`` runs its plain version; the JAX one
runs the Pallas kernel in interpret mode, as tests/test_cin_kernel.py does.
Both round xk and w1 to bf16 and sum in f32, so they differ only in the f32
summation order: rtol 1e-3 with atol 1e-3·max|ref| covers that with room,
while a wrong rounding site (bf16 x0, or bf16 Z) shows at the 1e-2 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.ops.interactions import CIN as JCIN
from ml_function_tpu.ops.kernels import cin as jcin
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.ops import interactions as tinteractions
from ml_function_tpu_torch.ops.base import init_parameters
from ml_function_tpu_torch.ops.interactions import CIN as TCIN
from ml_function_tpu_torch.ops.kernels import cin as tcin

torch.set_num_threads(1)

RTOL = 1e-3


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def _jax_params(cin, seed=0):
    return jax.tree_util.tree_map(np.asarray, cin.init(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("hidden", [(128,), (128, 128)])
def test_cin_layer_t_matches_jax_kernel(hidden):
    """Each layer of the chain, fed the same inputs in both packages."""
    b, f, d = 256, 5, 4
    rng = np.random.default_rng(0)
    e_t = rng.normal(0, 1, (d, b, f)).astype(np.float32)
    xk_t = e_t
    h_prev = f
    for h in hidden:
        w1 = (rng.normal(0, 1, (h_prev, f * h))
              * np.sqrt(2.0 / (h_prev * f + h))).astype(np.float32)
        want = np.array(jcin.cin_layer_t(jnp.asarray(xk_t), jnp.asarray(e_t),
                                         jnp.asarray(w1)))
        got = tcin.cin_layer_t(torch.from_numpy(xk_t), torch.from_numpy(e_t),
                               torch.from_numpy(w1))
        assert got.shape == (d, b, h) and got.dtype == torch.float32
        _close(got.numpy(), want)
        xk_t, h_prev = want, h


def test_cin_layer_t_keeps_x0_in_f32():
    """x0 is not rounded to bf16: an x0 with low bits set changes y."""
    d, b, h, f, o = 2, 8, 4, 3, 8
    rng = np.random.default_rng(1)
    xk = torch.from_numpy(rng.normal(0, 1, (d, b, h)).astype(np.float32))
    x0 = torch.from_numpy(rng.normal(0, 1, (d, b, f)).astype(np.float32))
    w1 = torch.from_numpy(rng.normal(0, 1, (h, f * o)).astype(np.float32))
    y = tcin.cin_layer_t(xk, x0, w1)
    y_bf16_x0 = tcin.cin_layer_t(xk, x0.bfloat16().float(), w1)
    assert not torch.equal(y, y_bf16_x0)
    u = xk.bfloat16().double() @ w1.bfloat16().double()
    exact = (u.view(d, b, f, o) * x0.double().unsqueeze(-1)).sum(2)
    np.testing.assert_allclose(y.numpy(), exact.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,f,d,hidden,route", [
    (256, 5, 4, (128, 128), "kernel"),   # supports() holds at every layer
    (96, 4, 4, (64,), "einsum"),         # B and O fail supports()
    (256, 5, 4, (64, 128), "einsum"),    # one layer fails: whole CIN on einsum
])
def test_cin_features_matches_jax(b, f, d, hidden, route, monkeypatch):
    jm = JCIN(f, d, hidden=hidden, out_logit=True, kernel="auto")
    params = _jax_params(jm)
    tm = TCIN(f, d, hidden=hidden, out_logit=True, kernel="auto")
    params_from_numpy(tm, params)
    e = np.random.default_rng(2).normal(0, 1, (b, f, d)).astype(np.float32)

    calls = []
    real = tinteractions.cin_layer_t
    monkeypatch.setattr(tinteractions, "cin_layer_t",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        got_feats = tm.features(torch.from_numpy(e))
        got_logit = tm(torch.from_numpy(e))
    assert bool(calls) == (route == "kernel")
    assert jcin.supports(b, f, hidden[0], d) == tcin.supports(b, f, hidden[0], d)
    _close(got_feats.numpy(), jm.features(params, jnp.asarray(e)))
    _close(got_logit.numpy(), jm(params, jnp.asarray(e)))


@pytest.mark.parametrize("kernel", ["pallas", "off"])
def test_cin_forced_routes_match_jax(kernel):
    # the reference's forced 'pallas' needs B % 256 == 0: below that its grid
    # is empty and it returns uninitialised memory (the port's kernel masks)
    b, f, d, hidden = 256, 3, 2, (128,)
    jm = JCIN(f, d, hidden=hidden, out_logit=False, kernel=kernel)
    params = _jax_params(jm, seed=3)
    tm = TCIN(f, d, hidden=hidden, out_logit=False, kernel=kernel)
    params_from_numpy(tm, params)
    e = np.random.default_rng(3).normal(0, 1, (b, f, d)).astype(np.float32)
    with torch.no_grad():
        got = tm.features(torch.from_numpy(e))
    _close(got.numpy(), jm.features(params, jnp.asarray(e)))


@pytest.mark.parametrize("shape", [(256, 5, 128, 4), (100, 5, 128, 4),
                                   (256, 5, 64, 4), (512, 26, 256, 8),
                                   (256, 0, 128, 4)])
def test_supports_matches_reference(shape):
    assert tcin.supports(*shape) == jcin.supports(*shape)


def test_cin_rejects_unknown_kernel_mode():
    with pytest.raises(ValueError, match="auto"):
        TCIN(3, 2, hidden=(8,), kernel="triton")


def test_cin_parameter_layout_is_the_reference_layout():
    tm = TCIN(26, 8, hidden=(128, 128))
    init_parameters(tm, torch.Generator().manual_seed(0))
    shapes = {k: tuple(v.shape) for k, v in tm.named_parameters()}
    assert shapes == {"w0": (26 * 26, 128), "w1": (128 * 26, 128),
                      "head.w": (256, 1), "head.b": (1,)}

