"""A numpy model of the (AU)GRU backward kernel's warp instance
(``ml_function_tpu_torch/ops/kernels/csrc/gru_bwd.cu``: ``gru_bwd_warp``),
which runs only on the card, and the wrapper's choice of instance.

The model follows the source index for index: the block's shared copies of
wh (each unit's column and row, padded to 16 units and to a row stride of
52), a warp's two batch rows with a lane per (row, unit), the bf16 h_prev
and dhh each row publishes for its lanes, the recurrent product and
wh · dhh summed in the plain version's order, da as a butterfly over the
row's 16 lanes, each thread's dwh slice (rows k of columns j, H + j and
2H + j) summed over every step, then the two rows of a warp, the block's
four warps in warp order, and the blocks in eight fixed slices in block
order (``gru_dwh_sum_kernel``). It runs in f64 with the bf16 roundings
left out and is held to the plain version
(``gru_sequence_backward_reference`` with ``cast_bf16=False``) in f64
within 1e-12 of max|ref|: a lane that reads another unit's column, a
padded unit or row that does not publish zeros, or a slice summed twice
misses that by orders of magnitude.
"""

import numpy as np
import pytest
import torch

from ml_function_tpu_torch.ops.kernels import gru as tgru

torch.set_num_threads(1)

WHP, WARPS, WLD, SUM_SLICES = 16, 4, 52, 8
WROWS = 2 * WARPS


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def stage_weights(wh, h):
    """``wsm[0]`` (unit u's column of each gate block) and ``wsm[1]`` (its
    row), zero past H, as the block stages them."""
    wsm = np.zeros((2, WHP * WLD))
    for e in range(WHP * 3 * WHP):
        u, c = divmod(e, 3 * WHP)
        g, k = divmod(c, WHP)
        if u < h and k < h:
            wsm[0, u * WLD + c] = wh[k, g * h + u]
            wsm[1, u * WLD + c] = wh[u, g * h + k]
    return wsm


def warp_instance(xw, wh, mask, att, h0, seq, dseq):
    """dxw, dwh, da, dh0 as the warp instance forms them, in f64."""
    b_total, l, h3 = xw.shape
    h = h3 // 3
    wsm = stage_weights(wh, h)
    j = np.arange(WHP)
    wcol = np.stack([wsm[0, u * WLD:u * WLD + 3 * WHP] for u in range(WHP)])  # (unit, c)
    wrow = np.stack([wsm[1, u * WLD:u * WLD + 3 * WHP] for u in range(WHP)])
    dxw, da = np.zeros_like(xw), np.zeros_like(att)
    dh0 = np.zeros_like(h0)
    blocks = -(-b_total // WROWS)
    part = np.zeros((blocks, h, h3))
    for blk in range(blocks):
        red = np.zeros((WARPS, WHP * 3 * WHP))
        for warp in range(WARPS):
            dw = np.zeros((2, 3, WHP, WHP))  # [half][g][k][lane j]
            for half in range(2):
                b = blk * WROWS + warp * 2 + half
                ok = (b < b_total) & (j < h)   # per lane
                bs = min(b, b_total - 1)
                dh = np.zeros(WHP)
                for t in reversed(range(l)):
                    def lane_vals(src):
                        return np.where(ok, src[np.minimum(j, h - 1)], 0.0)
                    hp = lane_vals(h0[bs] if t == 0 else seq[bs, t - 1])
                    xu, xr, xn = (lane_vals(xw[bs, t, g * h:(g + 1) * h]) for g in range(3))
                    m = np.where(ok, mask[bs, t], 0.0)
                    a = np.where(ok, att[bs, t], 0.0)
                    ds = lane_vals(dseq[bs, t])
                    hb = hp.copy()                        # the published row (bf16 left out)
                    hh = np.zeros((3, WHP))
                    for k in range(WHP):                  # in order over k, as gru.cuh
                        for g in range(3):
                            hh[g] = hh[g] + hb[k] * wcol[:, g * WHP + k]
                    u0, rg = _sigmoid(xu + hh[0]), _sigmoid(xr + hh[1])
                    n = np.tanh(xn + rg * hh[2])
                    u = a * u0
                    dh_t = dh + ds
                    dh_new = dh_t * m
                    dh_prev = dh_t * (1 - m) + dh_new * (1 - u)
                    du = dh_new * (n - hp)
                    dn = dh_new * u
                    dn_pre = dn * (1 - n * n)
                    du_pre = du * a * u0 * (1 - u0)
                    dr_pre = dn_pre * hh[2] * rg * (1 - rg)
                    own = np.stack([du_pre, dr_pre, dn_pre * rg])   # (3, lanes)
                    if b < b_total:
                        for g, v in enumerate((du_pre, dr_pre, dn_pre)):
                            dxw[b, t, g * h:(g + 1) * h] = v[:h]
                    dbuf = own.reshape(-1)                # dhh published: c = g * 16 + j
                    acc = np.zeros(WHP)
                    for c in range(3 * WHP):              # over c in order
                        acc = acc + dbuf[c] * wrow[:, c]
                    dh = dh_prev + acc
                    s_da = du * u0
                    for step in (8, 4, 2, 1):             # the butterfly
                        s_da = s_da + s_da[j ^ step]
                    if b < b_total:
                        da[b, t] = s_da[0]
                    for k in range(WHP):                  # the thread's dwh slice
                        dw[half, :, k] += hb[k] * own
                if b < b_total:
                    dh0[b] = dh[:h]
            slices = dw[0] + dw[1]                        # the halves' shuffle
            for g in range(3):
                for k in range(WHP):
                    red[warp, k * 3 * WHP + g * WHP + j] = slices[g, k]
        for e in range(WHP * 3 * WHP):
            k, c = divmod(e, 3 * WHP)
            g, jj = divmod(c, WHP)
            if k < h and jj < h:
                s = red[0, e]
                for w in range(1, WARPS):
                    s = s + red[w, e]
                part[blk, k, g * h + jj] = s
    per = -(-blocks // SUM_SLICES)
    sums = [part[sl * per:min(blocks, (sl + 1) * per)].sum(axis=0) if sl * per < blocks
            else np.zeros((h, h3)) for sl in range(SUM_SLICES)]
    dwh = sums[0]
    for s in sums[1:]:
        dwh = dwh + s
    return dxw, dwh, da, dh0


def _inputs(b, l, h, seed):
    rng = np.random.default_rng(seed)
    xw = rng.normal(size=(b, l, 3 * h)) * 0.5
    wh = rng.normal(size=(h, 3 * h)) / np.sqrt(h)
    att = rng.uniform(size=(b, l))
    lens = rng.integers(1, l + 1, size=b)
    mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.float64)
    mask[min(1, b - 1)] = 0.0                  # a row masked at every step
    h0 = rng.normal(size=(b, h)) * 0.5
    dseq = rng.normal(size=(b, l, h))
    return xw, wh, mask, att, h0, dseq


# (B, L, H): H 1, 8 and 16, a B that leaves the last block and the last
# warp's second row empty, and one past 8 blocks so that the sum kernel's
# slices hold more than one block
@pytest.mark.parametrize("b,l,h", [(3, 2, 1), (5, 3, 8), (11, 4, 16), (70, 2, 5)])
def test_warp_instance_model_matches_plain_version_in_f64(b, l, h):
    xw, wh, mask, att, h0, dseq = _inputs(b, l, h, seed=b * 100 + h)
    t = [torch.from_numpy(a) for a in (xw, wh, mask, att, h0)]
    seq = tgru.gru_sequence_reference(*t, cast_bf16=False)
    want = tgru.gru_sequence_backward_reference(*t, seq, torch.from_numpy(dseq),
                                                cast_bf16=False)
    got = warp_instance(xw, wh, mask, att, h0, seq.numpy(), dseq)
    for name, g, w in zip(("dxw", "dwh", "da", "dh0"), got, want):
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("h,name,rows", [(1, "gru_bwd_warp", 8), (16, "gru_bwd_warp", 8),
                                         (17, "gru_bwd", 15), (32, "gru_bwd", 8),
                                         (33, "gru_bwd", 7), (64, "gru_bwd", 4)])
def test_backward_instance_by_hidden_size(h, name, rows):
    assert tgru.backward_instance(h) == name
    assert tgru.backward_rows(h) == rows
    assert tgru.backward_rows(h) * h <= 1024      # threads a block of the block instance


@pytest.mark.parametrize("h", [0, 65, 128, 1100, 4000])
def test_backward_instance_refuses_past_the_kernels(h):
    """Below H 1 the kernels refuse; past 64 the wide instance takes every H
    (H 4000: one row a group), with rows and dwh partials its library plans
    (the wrapper passes no rows and asks ``gru_bwd_wide_partials``)."""
    if h == 0:
        with pytest.raises(ValueError, match="hidden size"):
            tgru.backward_instance(h)
        return
    assert tgru.backward_instance(h) == "gru_bwd_wide"
    assert tgru.backward_rows(h) is None


def test_warp_buffers_put_the_two_rows_on_distinct_banks():
    """A warp's two rows are 16 (h_prev) and 48 (dhh) floats apart: the
    halves' 16-byte loads of the same column take distinct banks, and each
    half's 16 lanes store to 16 distinct banks."""
    for ld in (WHP, 3 * WHP):
        lanes = np.arange(32)
        row, col = lanes // 16, lanes % 16
        banks = (row * ld + col) % 32
        assert len(set(banks)) == 32
        for c4 in range(ld // 4):
            quads = [set((r * ld + 4 * c4 + np.arange(4)) % 32) for r in (0, 1)]
            assert not quads[0] & quads[1]
    # the weight copies: 16 units' 16-byte chunks at stride WLD span all 32
    # banks twice, the least two wavefronts can give
    starts = (np.arange(WHP) * WLD) % 32
    banks = np.concatenate([s + np.arange(4) for s in starts]) % 32
    assert np.bincount(banks, minlength=32).max() == 2
