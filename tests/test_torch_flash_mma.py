"""A numpy model of the warp fragments of the split-TF32 flash kernels
(``ml_function_tpu_torch/ops/kernels/csrc/flash.cuh``, ``flash_fwd.cu``,
``flash_bwd_dq.cu``, ``flash_bwd_dkv.cu``), which run only on the card.

The model follows the sources index for index: the staged tiles' two
layouts ("rows" and "pairs") and their pads, the lane maps of mma.sync
m16n8k8's A, B and C fragments as the PTX ISA defines them, the key
permutation that lets a C fragment feed the next product as an A fragment,
the split of each operand into TF32 hi (rounded on its bits) and an
unrounded lo that the tensor cores truncate, and the online softmax on
fragments. One warp's work is run through it and held
against the plain formulas in f64 within 1e-5 of max|f64|, the kernels'
own bar: a lane map that is off by one column, a missing lo term or a
layout whose rows overlap misses it by orders of magnitude. A last test
counts the banks each quarter warp's 16-byte loads touch.
"""

import numpy as np
import pytest

LANE = np.arange(32)
G, T = LANE // 4, LANE % 4
NEG_INF = -1e9
LOG2E = 1.4426950408889634


def tf32(x):
    """``flash::tf32``: to nearest, ties away from zero, on the bits."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & ~np.uint64(0x1FFF)).astype(np.uint32).view(np.float32)


def truncate(x):
    """What the tensor cores read of an f32 register given as TF32."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split2(a, b):
    """{hi(a), hi(b), lo(a), lo(b)} along a last axis of 4; lo unrounded."""
    a, b = np.float32(a), np.float32(b)
    ha, hb = tf32(a), tf32(b)
    return np.stack([ha, hb, a - ha, b - hb], axis=-1)


def row_stride(dp):
    return 2 * dp + (16 if dp >= 16 else 0)


def pair_stride(dp):
    return 4 * dp + 8


def store_rows(x, dp):
    """A (rows, dh) tile in the "rows" layout (``Stager::store_rows``)."""
    rows, dh = x.shape
    xp = np.zeros((rows, dp), np.float32)
    xp[:, :dh] = x
    tile = np.full(rows * row_stride(dp), np.nan, np.float32)  # pads stay NaN
    for r in range(rows):
        for c in range(dp // 2):
            o = r * row_stride(dp) + 4 * c
            tile[o:o + 4] = split2(xp[r, 2 * c], xp[r, 2 * c + 1])
    return tile


def store_pairs(x, dp):
    """A (rows, dh) tile in the "pairs" layout (``Stager::store_pairs``)."""
    rows, dh = x.shape
    xp = np.zeros((rows, dp), np.float32)
    xp[:, :dh] = x
    tile = np.full(rows // 2 * pair_stride(dp), np.nan, np.float32)
    for p in range(rows // 2):
        for c in range(dp):
            o = p * pair_stride(dp) + 4 * c
            tile[o:o + 4] = split2(xp[2 * p, c], xp[2 * p + 1, c])
    return tile


def mma(d, a, b):
    """d + a·b for one m16n8k8: a (32, 4), b (32, 2), d (32, 4) per lane, in
    the fragment layouts of the PTX ISA, each operand truncated to TF32
    (products of TF32 values are exact; the model sums in f64)."""
    a, b = truncate(a), truncate(b)
    A = np.zeros((16, 8))
    A[G, T], A[G + 8, T], A[G, T + 4], A[G + 8, T + 4] = a.T
    B = np.zeros((8, 8))
    B[T, G], B[T + 4, G] = b.T
    C = np.zeros((16, 8))
    C[G, 2 * T], C[G, 2 * T + 1], C[G + 8, 2 * T], C[G + 8, 2 * T + 1] = d.T
    D = C + A @ B
    return np.stack([D[G, 2 * T], D[G, 2 * T + 1], D[G + 8, 2 * T], D[G + 8, 2 * T + 1]], 1)


def mma3(d, a, b):
    (ahi, alo), (bhi, blo) = a, b
    return mma(mma(mma(d, alo, bhi), ahi, blo), ahi, bhi)


def _quad(tile, offsets):
    return tile[offsets[:, None] + np.arange(4)]


def a_rows(tile, dp, r0, kk):
    x = _quad(tile, (r0 + G) * row_stride(dp) + kk * 16 + 4 * T)
    y = _quad(tile, (r0 + G + 8) * row_stride(dp) + kk * 16 + 4 * T)
    return (np.stack([x[:, 0], y[:, 0], x[:, 1], y[:, 1]], 1),
            np.stack([x[:, 2], y[:, 2], x[:, 3], y[:, 3]], 1))


def a_global(x, kk):
    """``flash::a_global``: the A fragment of rows 0..15 and k-step kk of x
    (16, dh), split as it is loaded; columns past dh are zero."""
    dh = x.shape[1]
    v = [np.where(c < dh, x[G + 8 * (e & 1), np.minimum(c, dh - 1)], 0)
         for e in range(4) for c in [kk * 8 + 2 * T + (e >> 1)]]
    c0, c1 = split2(v[0], v[1]), split2(v[2], v[3])
    return (np.stack([c0[:, 0], c0[:, 1], c1[:, 0], c1[:, 1]], 1),
            np.stack([c0[:, 2], c0[:, 3], c1[:, 2], c1[:, 3]], 1))


def a_from_c(c):
    """hi rounded to TF32, lo = c - hi, in the order c0, c2, c1, c3."""
    c = np.float32(c)
    hi = tf32(c)
    lo = c - hi
    return hi[:, [0, 2, 1, 3]], lo[:, [0, 2, 1, 3]]


def b_rows(tile, dp, r0, kk):
    x = _quad(tile, (r0 + G) * row_stride(dp) + kk * 16 + 4 * T)
    return x[:, :2], x[:, 2:]


def b_pairs(tile, dp, j, nd):
    x = _quad(tile, (4 * j + T) * pair_stride(dp) + 4 * (nd * 8 + G))
    return x[:, :2], x[:, 2:]


def _logits(s, scale, bias, rows, cols, causal, valid):
    """``flash::logit``, and -inf where the key or query does not exist."""
    s = np.float32(np.float32(s) * np.float32(scale)) + np.float32(bias)
    s = np.where(causal & (cols > rows), NEG_INF, s)
    return np.where(valid, s, -np.inf)


def fwd_warp(q, k, v, bias, scale, causal, dp, kt):
    """``flash_fwd_kernel`` for one warp at rows 0..15: q (16, dh), k and v
    (lk, dh), bias (lk,) → o (16, dh), lse (16,)."""
    dh, lk = q.shape[1], k.shape[0]
    qa = [a_global(q, kk) for kk in range(dp // 8)]
    acc = np.zeros((dp // 8, 32, 4))
    m, l = np.full((32, 2), NEG_INF), np.zeros((32, 2))
    for t0 in range(0, lk, kt):
        n = min(kt, lk - t0)
        pad = np.zeros((kt, dh), np.float32)
        kp, vp = pad.copy(), pad.copy()
        kp[:n], vp[:n] = k[t0:t0 + n], v[t0:t0 + n]
        ks, vs = store_rows(kp, dp), store_pairs(vp, dp)
        bs = np.zeros(kt, np.float32)
        bs[:n] = bias[t0:t0 + n]
        s = np.zeros((kt // 8, 32, 4))
        for j in range(kt // 8):
            for kk in range(dp // 8):
                s[j] = mma3(s[j], qa[kk], b_rows(ks, dp, 8 * j, kk))
            for e in range(4):
                col = 8 * j + 2 * T + (e & 1)
                s[j][:, e] = _logits(s[j][:, e], scale, bs[col], G + 8 * (e >> 1), t0 + col,
                                     causal, t0 + col < lk)
        mx = np.maximum(m, np.stack([s[:, :, :2].max(axis=(0, 2)), s[:, :, 2:].max(axis=(0, 2))], 1))
        mx = mx.reshape(8, 4, 2).max(axis=1).repeat(4, axis=0)   # across the quad
        alpha = np.exp(m - mx)
        m, l = mx, l * alpha
        acc *= alpha[None, :, [0, 0, 1, 1]]
        for j in range(kt // 8):
            p = np.exp2(s[j] * LOG2E - (m * LOG2E)[:, [0, 0, 1, 1]])
            l += np.stack([p[:, :2].sum(1), p[:, 2:].sum(1)], 1)
            for nd in range(dp // 8):
                acc[nd] = mma3(acc[nd], a_from_c(p), b_pairs(vs, dp, j, nd))
    l = np.maximum(l.reshape(8, 4, 2).sum(axis=1), 1e-30)   # the quad's sum, per row g
    o = np.zeros((16, dp))
    for nd in range(dp // 8):
        for e in range(4):
            o[G + 8 * (e >> 1), nd * 8 + 2 * T + (e & 1)] = acc[nd][:, e] / l[G, e >> 1]
    lse = np.concatenate([m[::4, 0] + np.log(l[:, 0]), m[::4, 1] + np.log(l[:, 1])])
    return o[:, :dh], lse


def mma3_add(acc, a, b):
    """``flash::mma3_add``: the product formed from zero, then added."""
    return acc + mma3(np.zeros((32, 4)), a, b)


# flash_bwd_dq.cu's tiling (``Dq<DP>``): keys a staged tile and a sub-tile
DQ_KT = {8: 64, 16: 64, 32: 32, 64: 16}
DQ_SUB = {8: 32, 16: 32, 32: 16, 64: 8}


def dq_warp(q, k, v, bias, lse, do, delta, scale, causal, dp):
    """``flash_bwd_dq_kernel`` for one warp at rows 0..15: q, do (16, dh),
    k, v (lk, dh), bias (lk,), lse, delta (16,) → dq (16, dh). At Dh 64
    (``SHARED_Q``) q and dO are read from split "rows" tiles, else held as
    A fragments split as they were loaded."""
    dh, lk = q.shape[1], k.shape[0]
    kt, sub = DQ_KT[dp], DQ_SUB[dp]
    if dp == 64:
        qs, dos = store_rows(q, dp), store_rows(do, dp)
        qa = [a_rows(qs, dp, 0, kk) for kk in range(dp // 8)]
        da = [a_rows(dos, dp, 0, kk) for kk in range(dp // 8)]
    else:
        qa = [a_global(q, kk) for kk in range(dp // 8)]
        da = [a_global(do, kk) for kk in range(dp // 8)]
    rows = G[:, None] + 8 * np.arange(2)[None, :]     # a lane's rows g, g + 8
    ls, dl = lse[rows], delta[rows]
    acc = np.zeros((dp // 8, 32, 4))
    for t0 in range(0, lk, kt):
        n = min(kt, lk - t0)
        kp_, vp_ = np.zeros((kt, dh), np.float32), np.zeros((kt, dh), np.float32)
        kp_[:n], vp_[:n] = k[t0:t0 + n], v[t0:t0 + n]
        ks, kpairs, vs = store_rows(kp_, dp), store_pairs(kp_, dp), store_rows(vp_, dp)
        bs = np.zeros(kt, np.float32)
        bs[:n] = bias[t0:t0 + n]
        for k0 in range(0, kt, sub):
            if t0 + k0 >= lk:
                break
            for j in range(sub // 8):
                s, dpt = np.zeros((32, 4)), np.zeros((32, 4))
                for kk in range(dp // 8):
                    s = mma3(s, qa[kk], b_rows(ks, dp, k0 + 8 * j, kk))
                    dpt = mma3(dpt, da[kk], b_rows(vs, dp, k0 + 8 * j, kk))
                for e in range(4):
                    col, r = k0 + 8 * j + 2 * T + (e & 1), e >> 1
                    x = _logits(s[:, e], scale, bs[col], G + 8 * r, t0 + col, causal,
                                t0 + col < lk)
                    p = np.exp2(x * LOG2E - ls[:, r] * LOG2E)
                    dpt[:, e] = p * (dpt[:, e] - dl[:, r])
                sa = a_from_c(dpt)
                for nd in range(dp // 8):
                    acc[nd] = mma3_add(acc[nd], sa, b_pairs(kpairs, dp, k0 // 8 + j, nd))
    dq = np.zeros((16, dp))
    for nd in range(dp // 8):
        for e in range(4):
            dq[G + 8 * (e >> 1), nd * 8 + 2 * T + (e & 1)] = acc[nd][:, e] * scale
    return dq[:, :dh]


def dkv_warp(q, k, v, bias, lse, do, delta, scale, causal, dp, qt):
    """``flash_bwd_dkv_kernel`` for one warp at keys 0..15: q, do (lq, dh),
    k, v (16, dh), bias (16,), lse, delta (lq,) → dk, dv (16, dh)."""
    lq, dh = q.shape
    ks, vs = store_rows(k, dp), store_rows(v, dp)
    bk = bias[G + 8 * np.arange(2)[:, None]].T
    dka, dva = np.zeros((dp // 8, 32, 4)), np.zeros((dp // 8, 32, 4))
    for t0 in range(0, lq, qt):
        n = min(qt, lq - t0)
        qp_, dp_ = np.zeros((qt, dh), np.float32), np.zeros((qt, dh), np.float32)
        qp_[:n], dp_[:n] = q[t0:t0 + n], do[t0:t0 + n]
        ls, dl = np.zeros(qt), np.zeros(qt)
        ls[:n], dl[:n] = lse[t0:t0 + n], delta[t0:t0 + n]
        qr, dr, qpr, dpr = (store_rows(qp_, dp), store_rows(dp_, dp),
                            store_pairs(qp_, dp), store_pairs(dp_, dp))
        st, dpt = np.zeros((qt // 8, 32, 4)), np.zeros((qt // 8, 32, 4))
        for kk in range(dp // 8):
            ka, va = a_rows(ks, dp, 0, kk), a_rows(vs, dp, 0, kk)
            for j in range(qt // 8):
                st[j] = mma3(st[j], ka, b_rows(qr, dp, 8 * j, kk))
                dpt[j] = mma3(dpt[j], va, b_rows(dr, dp, 8 * j, kk))
        for j in range(qt // 8):
            for e in range(4):
                i = 8 * j + 2 * T + (e & 1)
                s = _logits(st[j][:, e], scale, bk[:, e >> 1], t0 + i, G + 8 * (e >> 1),
                            causal, t0 + i < lq)
                p = np.exp2(s * LOG2E - ls[i] * LOG2E)
                st[j][:, e] = p
                dpt[j][:, e] = p * (dpt[j][:, e] - dl[i])
            pa, sa = a_from_c(st[j]), a_from_c(dpt[j])
            for nd in range(dp // 8):
                dva[nd] = mma3(dva[nd], pa, b_pairs(dpr, dp, j, nd))
                dka[nd] = mma3(dka[nd], sa, b_pairs(qpr, dp, j, nd))
    dk, dv = np.zeros((16, dp)), np.zeros((16, dp))
    for nd in range(dp // 8):
        for e in range(4):
            r, c = G + 8 * (e >> 1), nd * 8 + 2 * T + (e & 1)
            dk[r, c], dv[r, c] = dka[nd][:, e] * scale, dva[nd][:, e]
    return dk[:, :dh], dv[:, :dh]


def _exact(q, k, v, bias, scale, causal):
    """f64 logits (lq, lk), the key index on axis 1."""
    s = (q.astype(np.float64) @ k.T.astype(np.float64)) * scale + bias[None, :]
    rows, cols = np.arange(q.shape[0])[:, None], np.arange(k.shape[0])[None, :]
    return np.where(causal & (cols > rows), NEG_INF, s)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# (dh, dp, lk or lq, tile, causal): the path's width, a ragged last tile, the
# causal diagonal, an odd Dh padded to 16, and Dh 64 at its smaller tile
CASES = [(8, 8, 200, 64, False), (8, 8, 40, 64, True), (13, 16, 100, 64, False),
         (64, 64, 70, 32, True)]


def _key_bias(rng, n):
    """A fifth of the keys masked, key 0 never: every query keeps a valid key
    under the causal mask (a row with none is R4's, where the f64 logits
    keep q·k beside the -1e9 that the kernels' f32 rounding absorbs)."""
    bias = np.where(rng.uniform(size=n) < 0.2, NEG_INF, 0.0).astype(np.float32)
    bias[0] = 0.0
    return bias

@pytest.mark.parametrize("dh,dp,lk,kt,causal", CASES)
def test_forward_fragments_match_f64(dh, dp, lk, kt, causal):
    rng = np.random.default_rng(dh + lk)
    q = rng.standard_normal((16, dh)).astype(np.float32)
    k, v = (rng.standard_normal((lk, dh)).astype(np.float32) for _ in range(2))
    bias = _key_bias(rng, lk)
    scale = dh ** -0.5
    o, lse = fwd_warp(q, k, v, bias, scale, causal, dp, kt)
    s = _exact(q, k, v, bias, scale, causal)
    m = np.maximum(s.max(1, keepdims=True), NEG_INF)
    p = np.exp(s - m)
    want_o = p @ v.astype(np.float64) / p.sum(1, keepdims=True)
    assert _rel(o, want_o) < 1e-5
    np.testing.assert_allclose(lse, (m[:, 0] + np.log(p.sum(1))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dh,dp,lq,qt,causal", CASES)
def test_dkv_fragments_match_f64(dh, dp, lq, qt, causal):
    rng = np.random.default_rng(dh + lq + 1)
    q, do = (rng.standard_normal((lq, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((16, dh)).astype(np.float32) for _ in range(2))
    bias = _key_bias(rng, 16)
    scale = dh ** -0.5
    s = _exact(q, k, v, bias, scale, causal)
    m = np.maximum(s.max(1, keepdims=True), NEG_INF)
    lse = (m + np.log(np.exp(s - m).sum(1, keepdims=True)))[:, 0]
    p = np.exp(s - lse[:, None])
    o = p @ v.astype(np.float64)
    delta = (do.astype(np.float64) * o).sum(1)
    dk, dv = dkv_warp(q, k, v, bias, lse, do, delta, scale, causal, dp, qt)
    ds = p * (do.astype(np.float64) @ v.T.astype(np.float64) - delta[:, None])
    assert _rel(dv, p.T @ do.astype(np.float64)) < 1e-5
    assert _rel(dk, scale * ds.T @ q.astype(np.float64)) < 1e-5


@pytest.mark.parametrize("dh,dp,lk,_tile,causal", CASES)
def test_dq_fragments_match_f64(dh, dp, lk, _tile, causal):
    """dQ's warp at its own tiling (``DQ_KT``, ``DQ_SUB``): the same widths,
    ragged last tiles and causal diagonals as the other two kernels'."""
    rng = np.random.default_rng(dh + lk + 2)
    q, do = (rng.standard_normal((16, dh)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((lk, dh)).astype(np.float32) for _ in range(2))
    bias = _key_bias(rng, lk)
    scale = dh ** -0.5
    s = _exact(q, k, v, bias, scale, causal)
    m = np.maximum(s.max(1, keepdims=True), NEG_INF)
    lse = (m + np.log(np.exp(s - m).sum(1, keepdims=True)))[:, 0]
    p = np.exp(s - lse[:, None])
    delta = (do.astype(np.float64) * (p @ v.astype(np.float64))).sum(1)
    ds = p * (do.astype(np.float64) @ v.T.astype(np.float64) - delta[:, None])
    dq = dq_warp(q, k, v, bias, lse, do, delta, scale, causal, dp)
    assert _rel(dq, scale * ds @ k.astype(np.float64)) < 1e-5


@pytest.mark.parametrize("dp", [8, 16, 32, 64])
def test_quarter_warp_loads_hit_distinct_banks(dp):
    """Each 16-byte load (or store) of a quarter warp touches 32 distinct
    banks in both layouts, as the fragment reads and the stager's writes
    address them."""
    def banks(offsets):
        for quarter in range(4):
            o = offsets[8 * quarter:8 * quarter + 8]
            assert len(set(((o[:, None] + np.arange(4)) % 32).ravel())) == 32, (dp, o)

    for kk in range(dp // 8):
        banks((0 + G) * row_stride(dp) + kk * 16 + 4 * T)            # a_rows, b_rows
    for nd in range(dp // 8):
        banks(T * pair_stride(dp) + 4 * (nd * 8 + G))                 # b_pairs
    u = LANE
    banks((u // (dp // 2)) * row_stride(dp) + 4 * (u % (dp // 2)))   # store_rows
    banks((u // dp) * pair_stride(dp) + 4 * (u % dp))                 # store_pairs


def test_split_of_probabilities_has_no_bias():
    """What the tensor cores read of a split P (never negative): with hi
    rounded to nearest, lo takes either sign and its truncation cancels on
    average; with hi truncated, as ``a_from_c`` once did, lo has P's sign
    and every product comes out short. Such a shrink survives a long sum
    (a mean over 16,384 queries) where rounding to nearest averages out.
    P's own f32 rounding, up to 2^-24 of a value and zero on average, is
    the yardstick: the truncated split loses more than 2^-25 of P on
    average."""
    p = np.random.default_rng(0).uniform(0.0, 1.0, 1 << 20).astype(np.float32)
    p64 = p.astype(np.float64)

    def read(hi):
        return truncate(hi).astype(np.float64) + truncate(p - hi).astype(np.float64)

    rounded = ((read(tf32(p)) - p64) / p64).mean()
    truncated = ((read(truncate(p)) - p64) / p64).mean()
    assert abs(rounded) < 2.0 ** -27
    assert truncated < -(2.0 ** -25)
