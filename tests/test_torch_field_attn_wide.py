"""A numpy model of the field-attention kernels' wide instances
(``ml_function_tpu_torch/ops/kernels/csrc/field_attn_fwd.cu``:
``field_attn_fwd_wide``, ``csrc/field_attn_bwd.cu``: ``field_attn_bwd_wide``),
which run only on the card.

The models follow the sources index for index. L is max(Lq, Lk) rounded up
to 32 or 64; a block of ``WIDE_THREADS`` (64) threads takes 64 / L
(batch row, head) pairs, consecutive in (b, h) order, the last block's
spare slots idle. Each pair's L threads copy its rows (``fa::wide_rows_in``:
16 bytes a copy where Dh is a multiple of 4, else 4; thread t takes copies
t, t + L, …) into L rows of ``wide_stride(Dh)`` floats (Dh rounded up to 16,
and 4 more), the columns past Dh and the rows past Lq or Lk zero, and its
bias into L floats, −inf past Lk. A lane works on query t (or key t) of its
pair, 16 columns of a row at a time; the loops over keys (queries) skip
the groups of 8 that start at or past Lk (Lq):

- Forward (q, k and v staged): the lane's L logits, each the FMAs over d
  in order (a chunk of q_i against k_j), times scale, plus the bias; the
  max, the
  exponentials, their sum in torch.softmax's order (``fa::wide_sum``: for
  L 32 a tree over 32 slots, pairs 16 apart, then 8, 4, 2, 1; for L 64
  ``softmax_sum64``), the weights e / sum, then o_i = Σ_j a_ij · v_j over
  the keys in order, a chunk of columns at a time, stored for i < Lq and
  columns below Dh.
  (The kernel divides by ``fa::div_rn``, which gives the IEEE quotient's
  bits in its range; in f64 the model divides.)
- Backward, pass 1, lane on query i: the logits and dA_ij = dO_i · v_j,
  the weights a = e · (1 / sum), rowsum(a · dA), dS = a · (dA − rowsum),
  dQ_i = scale · Σ_j dS_ij k_j (stored for i < Lq), and the statistics
  (max, 1 / sum, rowsum) to the pair's float4 of query i, every lane
  included; pass 2, lane on key j: a_ij and dS_ij recomputed for every
  query from the staged rows and the statistics (a padded query, zero rows,
  adds exact zeros), dV_j and then dK_j over the queries in order, a chunk
  at a time, stored for j < Lk.

Shared memory is one array a block with the kernels' offsets, NaN where no
thread has written, so a lane that reads another pair's row, a padded
column or row that is not zero, a padded key whose bias is not −inf, a
statistic of the wrong query, or a copy to the wrong place spreads NaN or
misses by orders of magnitude. The models run in f64 and are held to the
plain versions (``field_attention_reference``,
``field_attention_backward_reference``) within 1e-12 of max|ref|. (The
order of the sums shows only in f32, on the card: chip_smoke.py and the
card tests hold the kernels to the plain versions there.)
"""

import numpy as np
import pytest
import torch

from ml_function_tpu_torch.ops.kernels import field_attention as tfa
from test_torch_field_attn_fwd import _inputs

torch.set_num_threads(1)

WIDE_THREADS, CW = 64, 16


def wide_stride(dh):
    return -(-dh // CW) * CW + 4


def fwd_pair_floats(l, dh):
    return 3 * l * wide_stride(dh) + l


def bwd_pair_floats(l, dh):
    return 4 * l * wide_stride(dh) + l + 4 * l


def rows_in(smem, at, src, b, hh, n, l, dh, vec):
    """``fa::wide_rows_in``: rows [0, n) of (b, hh) of the (B, n, H, dh)
    tensor ``src`` into l rows of s floats at smem[at:], by the pair's l
    threads, zero past dh and past n."""
    h = src.shape[2]
    s, stride, w = wide_stride(dh), h * dh, 4 if vec else 1
    per = (s - 4) // w
    flat = src.reshape(-1)
    base = (b * n * h + hh) * dh
    for t in range(l):
        for u in range(t, l * per, l):
            r, c = u // per, w * (u % per)
            ok = r < n and c < dh
            smem[at + r * s + c:at + r * s + c + w] = (
                flat[base + r * stride + c:base + r * stride + c + w] if ok else 0.0)


def wide_sum(e):
    """``fa::wide_sum`` over the first axis of e (L, lanes)."""
    l = e.shape[0]
    if l == 64:
        t = [(e[i] + e[i + 32]) + (e[i + 16] + e[i + 48]) for i in range(16)]
    else:
        t = [e[i] + e[i + 16] for i in range(16)]
    for gap in (8, 4, 2):
        for i in range(gap):
            t[i] = t[i] + t[i + gap]
    return t[0] + t[1]


def groups(l, n):
    """The keys (queries) of the loops over l that start a group of
    ``WIDE_GROUP`` (8) below n."""
    return [j for j0 in range(0, l, 8) if j0 < n for j in range(j0, j0 + 8)]


def lane_rows(smem, at, s, l, c0):
    """(l, CW): each lane's own row t, columns [c0, c0 + CW), as
    ``load_row``."""
    idx = at + np.arange(l) * s + c0
    return np.stack([smem[idx + c] for c in range(CW)], axis=1)


def store(dst, b, i, hh, row, c0, dh, scale):
    """``fa::wide_store`` of one lane's chunk: the columns below dh."""
    for c in range(CW):
        if c0 + c < dh:
            dst[b, i, hh, c0 + c] = row[c] * scale


def _layout(q, k):
    nbatch, lq, h, dh = q.shape
    lk = k.shape[1]
    l = 32 if max(lq, lk) <= 32 else 64
    return nbatch, lq, lk, h, dh, l, WIDE_THREADS // l, wide_stride(dh), dh % 4 == 0


def _pairs(nbatch, h, per):
    """Each block's live slots: (slot, b, hh)."""
    pairs = nbatch * h
    for blk in range(-(-pairs // per)):
        yield [(slot, *divmod(blk * per + slot, h)) for slot in range(per)
               if blk * per + slot < pairs]


def wide_forward(q, k, v, bias, scale):
    """o as ``field_attn_fwd_wide`` forms it, in the inputs' float type."""
    ft = q.dtype.type
    scale = ft(scale)
    nbatch, lq, lk, h, dh, l, per, s, vec = _layout(q, k)
    o = np.full_like(q, np.nan)
    for live in _pairs(nbatch, h, per):
        smem = np.full(per * fwd_pair_floats(l, dh), np.nan, dtype=q.dtype)
        for slot, b, hh in live:
            at = slot * fwd_pair_floats(l, dh)
            rows_in(smem, at, q, b, hh, lq, l, dh, vec)
            rows_in(smem, at + l * s, k, b, hh, lk, l, dh, vec)
            rows_in(smem, at + 2 * l * s, v, b, hh, lk, l, dh, vec)
            for t in range(l):
                smem[at + 3 * l * s + t] = bias[b, t] if t < lk else -np.inf
        for slot, b, hh in live:
            qs = slot * fwd_pair_floats(l, dh)
            ks, vs, bs = qs + l * s, qs + 2 * l * s, qs + 3 * l * s
            e = np.zeros((l, l), dtype=q.dtype)          # (key j, lane)
            for c0 in range(0, s - 4, CW):
                x = lane_rows(smem, qs, s, l, c0)
                for j in groups(l, lk):
                    y = smem[ks + j * s + c0:ks + j * s + c0 + CW]
                    for c in range(CW):                  # the FMAs in order
                        e[j] = e[j] + x[:, c] * y[c]
            e = e * scale + smem[bs:bs + l][:, None]
            e = np.exp(e - e.max(axis=0))
            a = e / wide_sum(e)
            for i in range(lq):
                for c0 in range(0, s - 4, CW):
                    acc = np.zeros(CW, dtype=q.dtype)
                    for j in groups(l, lk):
                        acc = acc + a[j, i] * smem[vs + j * s + c0:vs + j * s + c0 + CW]
                    store(o, b, i, hh, acc, c0, dh, 1)
    return o


def wide_backward(q, k, v, bias, do, scale):
    """(dq, dk, dv) as ``field_attn_bwd_wide`` forms them, in the inputs'
    float type."""
    ft = q.dtype.type
    scale = ft(scale)
    nbatch, lq, lk, h, dh, l, per, s, vec = _layout(q, k)
    dq, dk, dv = (np.full_like(t, np.nan) for t in (q, k, v))
    for live in _pairs(nbatch, h, per):
        smem = np.full(per * bwd_pair_floats(l, dh), np.nan, dtype=q.dtype)
        for slot, b, hh in live:
            at = slot * bwd_pair_floats(l, dh)
            for n, (src, rows) in enumerate(((q, lq), (do, lq), (k, lk), (v, lk))):
                rows_in(smem, at + n * l * s, src, b, hh, rows, l, dh, vec)
            for t in range(l):
                smem[at + 4 * l * s + t] = bias[b, t] if t < lk else -np.inf
        for slot, b, hh in live:                         # pass 1: a lane on a query
            qs = slot * bwd_pair_floats(l, dh)
            dos, ks, vs = qs + l * s, qs + 2 * l * s, qs + 3 * l * s
            bs, st = qs + 4 * l * s, qs + 4 * l * s + l  # query i's float4 at st + 4 i
            a = np.zeros((l, l), dtype=q.dtype)          # (key j, lane)
            d = np.zeros((l, l), dtype=q.dtype)
            for c0 in range(0, s - 4, CW):
                x = lane_rows(smem, qs, s, l, c0)
                for j in groups(l, lk):
                    for c in range(CW):
                        a[j] = a[j] + x[:, c] * smem[ks + j * s + c0 + c]
            for c0 in range(0, s - 4, CW):
                y = lane_rows(smem, dos, s, l, c0)
                for j in groups(l, lk):
                    for c in range(CW):
                        d[j] = d[j] + y[:, c] * smem[vs + j * s + c0 + c]
            a = a * scale + smem[bs:bs + l][:, None]
            m = a.max(axis=0)
            a = np.exp(a - m)
            inv = 1 / wide_sum(a)
            a = a * inv
            rs = (a * d).sum(axis=0)
            d = a * (d - rs)
            for i in range(lq):
                for c0 in range(0, s - 4, CW):
                    acc = np.zeros(CW, dtype=q.dtype)
                    for j in groups(l, lk):
                        acc = acc + d[j, i] * smem[ks + j * s + c0:ks + j * s + c0 + CW]
                    store(dq, b, i, hh, acc, c0, dh, scale)
            for t in range(l):
                smem[st + 4 * t:st + 4 * t + 4] = (m[t], inv[t], rs[t], 0.0)
        for slot, b, hh in live:                         # pass 2: a lane on a key
            qs = slot * bwd_pair_floats(l, dh)
            dos, ks, vs = qs + l * s, qs + 2 * l * s, qs + 3 * l * s
            bs, st = qs + 4 * l * s, qs + 4 * l * s + l
            a = np.zeros((l, l), dtype=q.dtype)          # (query i, lane)
            d = np.zeros((l, l), dtype=q.dtype)
            for c0 in range(0, s - 4, CW):
                kj = lane_rows(smem, ks, s, l, c0)
                for i in groups(l, lq):
                    for c in range(CW):
                        a[i] = a[i] + smem[qs + i * s + c0 + c] * kj[:, c]
            for c0 in range(0, s - 4, CW):
                vj = lane_rows(smem, vs, s, l, c0)
                for i in groups(l, lq):
                    for c in range(CW):
                        d[i] = d[i] + smem[dos + i * s + c0 + c] * vj[:, c]
            stats = smem[st:st + 4 * l].reshape(l, 4)
            a = np.exp(a * scale + smem[bs:bs + l][None, :] - stats[:, :1]) * stats[:, 1:2]
            d = a * (d - stats[:, 2:3])
            for j in range(lk):
                for c0 in range(0, s - 4, CW):
                    va = np.zeros(CW, dtype=q.dtype)
                    for i in groups(l, lq):
                        va = va + a[i, j] * smem[dos + i * s + c0:dos + i * s + c0 + CW]
                    store(dv, b, j, hh, va, c0, dh, 1)
                    ka = np.zeros(CW, dtype=q.dtype)
                    for i in groups(l, lq):
                        ka = ka + d[i, j] * smem[qs + i * s + c0:qs + i * s + c0 + CW]
                    store(dk, b, j, hh, ka, c0, dh, scale)
    return dq, dk, dv


# (B, Lq, Lk, H, Dh): AutoInt at 2 heads of 32 with an odd count of pairs
# (the last block's second slot idle), the gate's Dh-64 edge, H past 8 at a
# narrow head, a ragged Dh (4-byte copies, zero columns in the last chunk),
# Lq ≠ Lk both ways past 32, one query against 64 keys, 64 queries against
# one key, and 32 positions at Dh 48 (three chunks)
CASES = [(3, 27, 27, 1, 32), (2, 64, 64, 2, 64), (3, 12, 12, 10, 8), (2, 27, 27, 2, 17),
         (2, 40, 24, 3, 32), (2, 24, 40, 2, 20), (3, 1, 64, 2, 20), (2, 64, 1, 1, 36),
         (2, 32, 32, 3, 48)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,lq,lk,h,dh", CASES)
def test_wide_forward_model_matches_plain_version_in_f64(b, lq, lk, h, dh):
    q, k, v, bias, scale = _inputs(b, lq, lk, h, dh, seed=b * 1000 + lq * 10 + h)
    want = tfa.field_attention_reference(*_torch(q, k, v, bias), scale).numpy()
    got = wide_forward(q, k, v, bias, scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("b,lq,lk,h,dh", CASES)
def test_wide_backward_model_matches_plain_version_in_f64(b, lq, lk, h, dh):
    q, k, v, bias, scale = _inputs(b, lq, lk, h, dh, seed=b * 1000 + lq * 10 + h + 1)
    do = np.random.default_rng(lq + lk + dh).normal(size=q.shape)
    want = tfa.field_attention_backward_reference(*_torch(q, k, v, bias, do), scale)
    got = wide_backward(q, k, v, bias, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=name)


def test_wide_models_give_a_fully_masked_row_uniform_weights():
    """In f32, batch row 1, whose keys are all masked, gets o = mean(V) and
    dV_j = mean over the queries' dO (uniform weights over all Lk keys; the
    padded keys' −inf bias gives them none)."""
    q, k, v, bias, scale = (a.astype(np.float32) if isinstance(a, np.ndarray) else a
                            for a in _inputs(3, 27, 27, 2, 32, seed=7))
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    got = wide_forward(q, k, v, bias, scale)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(axis=0), got[1].shape),
                               rtol=0, atol=1e-6)
    _, _, dv = wide_backward(q, k, v, bias, do, scale)
    np.testing.assert_allclose(dv[1], np.broadcast_to(do[1].sum(axis=0) / 27, dv[1].shape),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("lk", [1, 7, 16, 17, 27, 32])
def test_wide_sum_over_32_slots_is_torch_softmax_order(lk):
    """With 32 slots, zeros past lk: torch.softmax's warp butterfly over the
    row's keys (for 16 keys or fewer, over its narrower warp: the zeros
    leave its sums exact), as the warp instance forms it."""
    e = np.zeros((32, 5), dtype=np.float32)
    e[:lk] = np.random.default_rng(lk).uniform(size=(lk, 5)).astype(np.float32)
    t = [(e[i] + e[i + 16]) + (e[i + 8] + e[i + 24]) for i in range(8)]
    for gap in (4, 2, 1):
        for i in range(gap):
            t[i] = t[i] + t[i + gap]
    np.testing.assert_array_equal(wide_sum(e), t[0])
