"""A numpy model of the (AU)GRU forward kernel's warp instance
(``ml_function_tpu_torch/ops/kernels/csrc/gru_fwd.cu``: ``gru_fwd_warp``),
which runs only on the card, and the wrapper's choice of forward instance.

The model follows the source index for index: blocks of four warps, a
warp's two batch rows with a lane per (row, unit), the hidden units padded
to 16, each thread's three columns of wh (rows k of columns j, H + j and
2H + j, zero past H) held for every step, the bf16 h each row publishes in
a buffer chosen by the step's parity (zeros from padded units and rows),
the recurrent product summed over k in order, and the step's gate
arithmetic (``gru::step``). It runs in f64 with the bf16 roundings left out
and is held to the plain version (``gru_sequence_reference`` with
``cast_bf16=False``) in f64 within 1e-12 of max|ref|: a lane that reads
another unit's column or the other row's published h, or a weight copied
transposed, misses that by orders of magnitude, and a padded unit that
publishes a NaN (which its zero weights would not cancel) fails it.
"""

import numpy as np
import pytest
import torch

from ml_function_tpu_torch.ops.kernels import gru as tgru

torch.set_num_threads(1)

WHP, WARPS = 16, 4
WROWS = 2 * WARPS


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def step(hv, xu, xr, xn, m, a, hu, hr, hn):
    """``gru::step``: h' of one (row, unit), in the plain version's order."""
    u0 = _sigmoid(xu + hu)
    rg = _sigmoid(xr + hr)
    n = np.tanh(xn + rg * hn)
    u = a * u0
    h_new = (1.0 - u) * hv + u * n
    return m * h_new + (1.0 - m) * hv


def warp_instance(xw, wh, mask, att, h0):
    """seq as ``gru_fwd_warp`` forms it, in f64 (bf16 roundings left out)."""
    b_total, l, h3 = xw.shape
    h = h3 // 3
    j = np.arange(WHP)
    # each thread's registers: w[g][k, j] = wh[k, g * H + j], zero past H
    w = np.zeros((3, WHP, WHP))
    for g in range(3):
        w[g, :h, :h] = wh[:, g * h:(g + 1) * h]
    seq = np.full((b_total, l, h), np.nan)
    for blk in range(-(-b_total // WROWS)):
        for warp in range(WARPS):
            hbuf = np.full((2, 2 * WHP), np.nan)      # [parity][half * 16 + unit]
            rows = [blk * WROWS + warp * 2 + half for half in range(2)]
            ok = [(b < b_total) & (j < h) for b in rows]

            def lane_vals(src, half):   # a lane outside B x H reads a valid place, takes 0
                row = src[min(rows[half], b_total - 1)]
                return np.where(ok[half], row[np.minimum(j, h - 1)], 0.0)

            hv = [lane_vals(h0, half) for half in range(2)]
            for t in range(l):
                for half in range(2):                 # each lane publishes its h
                    hbuf[t & 1, half * WHP + j] = np.where(ok[half], hv[half], 0.0)
                for half in range(2):                 # after the __syncwarp
                    b = min(rows[half], b_total - 1)
                    hb = hbuf[t & 1, half * WHP:(half + 1) * WHP]
                    hh = np.zeros((3, WHP))
                    for k in range(WHP):              # over k in order
                        for g in range(3):
                            hh[g] = hh[g] + hb[k] * w[g, k]
                    xu, xr, xn = (lane_vals(xw[:, t, g * h:(g + 1) * h], half)
                                  for g in range(3))
                    m = np.where(ok[half], mask[b, t], 0.0)
                    a = np.where(ok[half], att[b, t], 0.0)
                    hv[half] = step(hv[half], xu, xr, xn, m, a, *hh)
                    if rows[half] < b_total:
                        seq[rows[half], t] = hv[half][:h]
    return seq


def _inputs(b, l, h, seed):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(b, l, 3 * h)) * 0.5
    wh = rng.normal(size=(h, 3 * h)) / np.sqrt(h)
    att = rng.uniform(size=(b, l))
    lens = rng.integers(1, l + 1, size=b)
    mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.float64)
    mask[min(1, b - 1)] = 0.0                  # a row masked at every step
    h0 = rng.normal(size=(b, h)) * 0.5         # which it must carry through
    return xw, wh, mask, att, h0


# (B, L, H): H 16 and 13 (three padded units), H 1 and 8, B not a multiple
# of a block's 8 rows (the last warp's second row, or the whole last warp,
# past B)
@pytest.mark.parametrize("b,l,h", [(11, 5, 16), (13, 6, 13), (3, 4, 1), (17, 3, 8),
                                   (16, 2, 16)])
def test_warp_instance_model_matches_plain_version_in_f64(b, l, h):
    xw, wh, mask, att, h0 = _inputs(b, l, h, seed=b * 100 + h)
    want = tgru.gru_sequence_reference(*(torch.from_numpy(a) for a in
                                         (xw, wh, mask, att, h0)),
                                       cast_bf16=False).numpy()
    got = warp_instance(xw, wh, mask, att, h0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())
    assert np.array_equal(got[1], np.broadcast_to(h0[1], got[1].shape))   # h0 exactly


@pytest.mark.parametrize("h,name,rows", [(1, "gru_fwd_warp", 8), (16, "gru_fwd_warp", 8),
                                         (17, "gru_fwd", 15), (32, "gru_fwd", 8),
                                         (64, "gru_fwd", 4)])
def test_forward_instance_by_hidden_size(h, name, rows):
    assert tgru.forward_instance(h) == name
    assert tgru.instance_rows(name, h) == rows
    assert rows * h <= 256                          # threads a block of the block instance
    # the backward takes the same limits
    assert tgru.backward_instance(h) == name.replace("fwd", "bwd")


@pytest.mark.parametrize("h", [0, 65, 128, 1100])
def test_forward_instance_refuses_past_the_kernels(h):
    """Below H 1 the kernels refuse; past 64, where the block instance ends,
    the wide instance takes every H, with rows its library plans (the
    wrapper passes none)."""
    if h == 0:
        with pytest.raises(ValueError, match="hidden size"):
            tgru.forward_instance(h)
        return
    assert tgru.forward_instance(h) == "gru_fwd_wide"
    assert tgru.instance_rows("gru_fwd_wide", h) is None
