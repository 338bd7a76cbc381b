"""A numpy model of the field-attention kernels' L-64 instances
(``ml_function_tpu_torch/ops/kernels/csrc/field_attn_fwd.cu``:
``field_attn_fwd_l64``, ``csrc/field_attn_bwd.cu``: ``field_attn_bwd_l64``),
which run only on the card.

The models follow the sources index for index. A block takes
``warp_rows(H)`` batch rows with 32 · rows · H threads, and each thread
copies the slab columns of ``fa::SlabCol`` (the helpers of
``tests/test_torch_field_attn_fwd.py``, shared with the warp instance):
q (and dO) as one slab, k and v batch row by batch row into padded slabs
of 64 rows, zero past Lk, with the bias padded by −inf
(``fa::l64_keys_in``). Then one warp works on one (b, h), a lane on query
i in a first turn and on query i + 32 in a second, where Lq passes 32.

- Forward: the lane keeps its query's 64 logits in registers (the FMAs
  over d in order, times scale, plus the bias: −inf on a padded key), then
  their max, the exponentials, their sum in torch.softmax's order (slot l
  holds e[l] + e[l + 32], then pairs 16 apart, 8, 4, 2, 1), o_i =
  Σ_j (e_ij / sum) · v_j over the 64 keys in order into q_i's slot, and the
  block's copy out. (The kernel divides by ``fa::div_rn``, which gives the
  IEEE quotient's bits in its range; in f64 the model divides.)
- Backward, pass 1, lane on query i: the weights a = e · (1 / sum) in
  registers, rowsum(a · dA), dQ_i = scale · Σ_j a_ij (dA_ij − rowsum) k_j
  into the dQ slab, and the query's statistics (max, 1 / sum, rowsum) as a
  float4 in the warp's row of the statistics.
- Backward, pass 2, lane on key j < Lk (then j + 32): a_ij and dS_ij
  recomputed from q_i, dO_i and the statistics, dV_j and dK_j summed over
  the queries in order, written into the slots of v_j and k_j, and the
  first Lk rows of each batch row copied out (``fa::l64_keys_out``).

Shared memory is one array with the kernels' offsets, NaN where no thread
has written, so a read of a slot nothing wrote, a lane that reads another
head's row, a padded column that is not zero, a statistic read from
another warp's row or a key row read after pass 2 overwrote it spreads NaN
or misses by orders of magnitude, and so does a padded key row left
unwritten or a padded key whose bias is not −inf. The models run in f64 and are held to
the plain versions (``field_attention_reference``,
``field_attention_backward_reference``) within 1e-12 of max|ref|. (The
order of the forward's sum shows only in f32, on the card: chip_smoke.py
and the card tests hold the kernels to the plain versions there.)
"""

import numpy as np
import pytest
import torch

from ml_function_tpu_torch.ops.kernels import field_attention as tfa
from test_torch_field_attn_fwd import _inputs, slab_out, slab_stride, slabs_in, warp_rows

torch.set_num_threads(1)

L64 = 64


def fwd_smem_floats(lq, h, dp):
    nb, s = warp_rows(h), slab_stride(h, dp)
    return nb * (lq + 2 * L64) * s + nb * L64


def bwd_smem_floats(lq, h, dp):
    nb, s = warp_rows(h), slab_stride(h, dp)
    return nb * (3 * lq + 2 * L64) * s + nb * L64 + nb * h * lq * 4


def keys_in(smem, at_k, at_v, at_b, k, v, bias, b0, nb, lk, h, dh, dp, vec, threads):
    """``fa::l64_keys_in``: each batch row's k and v into L64 slab rows, the
    rows past lk zero, and its bias into L64 floats, -inf past lk."""
    s = slab_stride(h, dp)
    for bl in range(nb):
        slabs_in(smem, at_k + bl * L64 * s, k, b0 + bl, 1, lk, h, dh, dp, vec, threads)
        slabs_in(smem, at_v + bl * L64 * s, v, b0 + bl, 1, lk, h, dh, dp, vec, threads)
        for at in (at_k, at_v):
            smem[at + (bl * L64 + lk) * s:at + (bl + 1) * L64 * s] = 0.0
        smem[at_b + bl * L64:at_b + (bl + 1) * L64] = -np.inf
        smem[at_b + bl * L64:at_b + bl * L64 + lk] = bias[b0 + bl]


def keys_out(dst, smem, at, b0, nb, lk, h, dh, dp, vec, threads):
    """``fa::l64_keys_out``: the first lk slab rows of each batch row."""
    for bl in range(nb):
        slab_out(dst, smem[at + bl * L64 * slab_stride(h, dp):], b0 + bl, 1, lk, h, dh, dp,
                 vec, threads)


def softmax_sum64(e):
    """``fa::softmax_sum64`` over the first axis of e (L64, lanes)."""
    t = [(e[l] + e[l + 32]) + (e[l + 16] + e[l + 48]) for l in range(16)]
    for gap in (8, 4, 2):
        for l in range(gap):
            t[l] = t[l] + t[l + gap]
    return t[0] + t[1]


def rows_of(smem, at, idx, dp):
    """(len(idx), DP): the DP floats at smem[at + idx[n]:], as ``load_row``."""
    return np.stack([smem[at + idx + c] for c in range(dp)], axis=1)


def exps64(smem, x, kh, s, bh, scale, ft):
    """``fa::exps64`` for lanes x (n, DP) over the L64 keys of a padded slab:
    the exponentials (L64, n), zero past lk, and each lane's max."""
    e = np.zeros((L64, x.shape[0]), dtype=ft)
    m = np.full(x.shape[0], -np.inf, dtype=ft)
    for j in range(L64):
        y = smem[kh + j * s:kh + j * s + x.shape[1]]
        d = np.zeros(x.shape[0], dtype=ft)
        for c in range(x.shape[1]):                   # the FMAs in order
            d = d + x[:, c] * y[c]
        e[j] = d * scale + smem[bh + j]
        m = np.maximum(m, e[j])
    return np.exp(e - m), m


def _layout(q, k):
    nbatch, lq, h, dh = q.shape
    lk = k.shape[1]
    dp = 8 if dh <= 8 else 16
    rows = warp_rows(h)
    return nbatch, lq, lk, h, dh, dp, dh % 4 == 0, rows, slab_stride(h, dp), 32 * rows * h


def l64_forward(q, k, v, bias, scale):
    """o as ``field_attn_fwd_l64`` forms it, in the inputs' float type."""
    ft = q.dtype.type
    scale = ft(scale)
    nbatch, lq, lk, h, dh, dp, vec, rows, s, threads = _layout(q, k)
    o = np.full_like(q, np.nan)
    for blk in range(-(-nbatch // rows)):
        b0 = blk * rows
        nb = min(rows, nbatch - b0)
        smem = np.full(fwd_smem_floats(lq, h, dp), np.nan, dtype=q.dtype)
        at_k = rows * lq * s
        at_v = at_k + rows * L64 * s
        at_b = at_v + rows * L64 * s
        slabs_in(smem, 0, q, b0, nb, lq, h, dh, dp, vec, threads)
        keys_in(smem, at_k, at_v, at_b, k, v, bias, b0, nb, lk, h, dh, dp, vec, threads)
        for warp in range(rows * h):
            bl, hh = divmod(warp, h)
            if bl >= nb:
                continue
            kh = at_k + bl * L64 * s + hh * dp             # key j at kh + j * s
            vh = at_v + bl * L64 * s + hh * dp
            bh = at_b + bl * L64
            for i0 in range(0, lq, 32):                    # the lanes' turns
                qi = (bl * lq + np.arange(i0, min(i0 + 32, lq))) * s + hh * dp
                e, _ = exps64(smem, rows_of(smem, 0, qi, dp), kh, s, bh, scale, ft)
                total = softmax_sum64(e)
                acc = np.zeros((qi.size, dp), dtype=q.dtype)
                for j in range(L64):
                    a = e[j] / total
                    acc = acc + a[:, None] * smem[vh + j * s:vh + j * s + dp][None, :]
                for c in range(dp):                        # o_i into q_i's slot
                    smem[qi + c] = acc[:, c]
        slab_out(o, smem, b0, nb, lq, h, dh, dp, vec, threads)
    return o


def l64_backward(q, k, v, bias, do, scale):
    """(dq, dk, dv) as ``field_attn_bwd_l64`` forms them, in the inputs'
    float type."""
    ft = q.dtype.type
    scale = ft(scale)
    nbatch, lq, lk, h, dh, dp, vec, rows, s, threads = _layout(q, k)
    dq, dk, dv = (np.full_like(t, np.nan) for t in (q, k, v))
    for blk in range(-(-nbatch // rows)):
        b0 = blk * rows
        nb = min(rows, nbatch - b0)
        smem = np.full(bwd_smem_floats(lq, h, dp), np.nan, dtype=q.dtype)
        at_do = rows * lq * s
        at_dq = at_do + rows * lq * s
        at_k = at_dq + rows * lq * s
        at_v = at_k + rows * L64 * s
        at_b = at_v + rows * L64 * s
        at_st = at_b + rows * L64
        slabs_in(smem, 0, q, b0, nb, lq, h, dh, dp, vec, threads)
        slabs_in(smem, at_do, do, b0, nb, lq, h, dh, dp, vec, threads)
        keys_in(smem, at_k, at_v, at_b, k, v, bias, b0, nb, lk, h, dh, dp, vec, threads)
        for warp in range(rows * h):
            bl, hh = divmod(warp, h)
            if bl >= nb:
                continue
            qh = bl * lq * s + hh * dp                     # query i at qh + i * s
            doh, dqh = at_do + qh, at_dq + qh
            kh = at_k + bl * L64 * s + hh * dp             # key j at kh + j * s
            vh = at_v + bl * L64 * s + hh * dp
            bh = at_b + bl * L64
            st = at_st + warp * lq * 4                     # query i's float4 at st + 4 i
            for i0 in range(0, lq, 32):                    # pass 1: a lane on a query
                i = np.arange(i0, min(i0 + 32, lq))
                e, m = exps64(smem, rows_of(smem, qh, i * s, dp), kh, s, bh, scale, ft)
                inv = 1 / softmax_sum64(e)
                a = e * inv
                x = rows_of(smem, doh, i * s, dp)
                rs = np.zeros(i.size, dtype=q.dtype)
                for j in range(L64):
                    d = np.zeros(i.size, dtype=q.dtype)
                    for c in range(dp):
                        d = d + x[:, c] * smem[vh + j * s + c]
                    rs = rs + a[j] * d
                dqa = np.zeros((i.size, dp), dtype=q.dtype)
                for j in range(L64):
                    d = np.zeros(i.size, dtype=q.dtype)
                    for c in range(dp):
                        d = d + x[:, c] * smem[vh + j * s + c]
                    ds = a[j] * (d - rs)
                    dqa = dqa + ds[:, None] * smem[kh + j * s:kh + j * s + dp][None, :]
                for c in range(dp):
                    smem[dqh + i * s + c] = dqa[:, c] * scale
                for f, val in enumerate((m, inv, rs, np.zeros_like(rs))):
                    smem[st + 4 * i + f] = val
            for j0 in range(0, lk, 32):                    # pass 2: a lane on a key
                j = np.arange(j0, min(j0 + 32, lk))
                kj = rows_of(smem, kh, j * s, dp)
                vj = rows_of(smem, vh, j * s, dp)
                bj = smem[bh + j]
                dka = np.zeros((j.size, dp), dtype=q.dtype)
                dva = np.zeros((j.size, dp), dtype=q.dtype)
                for i in range(lq):
                    sti = smem[st + 4 * i:st + 4 * i + 4]
                    x = smem[qh + i * s:qh + i * s + dp]
                    d = np.zeros(j.size, dtype=q.dtype)
                    for c in range(dp):
                        d = d + x[c] * kj[:, c]
                    a = np.exp(d * scale + bj - sti[0]) * sti[1]
                    y = smem[doh + i * s:doh + i * s + dp]
                    d = np.zeros(j.size, dtype=q.dtype)
                    for c in range(dp):
                        d = d + y[c] * vj[:, c]
                    ds = a * (d - sti[2])
                    dva = dva + a[:, None] * y[None, :]
                    dka = dka + ds[:, None] * x[None, :]
                for c in range(dp):                        # into k_j's and v_j's slots
                    smem[kh + j * s + c] = dka[:, c] * scale
                    smem[vh + j * s + c] = dva[:, c]
        slab_out(dq, smem[at_dq:], b0, nb, lq, h, dh, dp, vec, threads)
        keys_out(dk, smem, at_k, b0, nb, lk, h, dh, dp, vec, threads)
        keys_out(dv, smem, at_v, b0, nb, lk, h, dh, dp, vec, threads)
    return dq, dk, dv


# (B, Lq, Lk, H, Dh): DMIN's refiner with a B not a multiple of its 2 batch
# rows a block, Lq ≠ Lk both ways (a second turn of queries only, or of keys
# only), a ragged Dh (4-byte copies, DP 16), H 8 (one batch row, 8 warps),
# one query against 64 keys, and 64 queries against one key
CASES = [(9, 64, 64, 2, 8), (5, 33, 64, 3, 16), (6, 64, 40, 1, 13), (3, 64, 33, 8, 16),
         (5, 1, 64, 2, 4), (3, 64, 1, 1, 8)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b,lq,lk,h,dh", CASES)
def test_l64_forward_model_matches_plain_version_in_f64(b, lq, lk, h, dh):
    q, k, v, bias, scale = _inputs(b, lq, lk, h, dh, seed=b * 1000 + lq * 10 + h)
    want = tfa.field_attention_reference(*_torch(q, k, v, bias), scale).numpy()
    got = l64_forward(q, k, v, bias, scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("b,lq,lk,h,dh", CASES)
def test_l64_backward_model_matches_plain_version_in_f64(b, lq, lk, h, dh):
    q, k, v, bias, scale = _inputs(b, lq, lk, h, dh, seed=b * 1000 + lq * 10 + h + 1)
    do = np.random.default_rng(lq + lk).normal(size=q.shape)
    want = tfa.field_attention_backward_reference(*_torch(q, k, v, bias, do), scale)
    got = l64_backward(q, k, v, bias, do, scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = w.numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12 * np.abs(w).max(), err_msg=name)


def test_l64_models_give_a_fully_masked_row_uniform_weights():
    """In f32, a logit rounded after the product times scale and again after
    the bias is −1e9 exactly for every masked key whose |product · scale| is
    below 32: batch row 1, whose keys are all masked, gets o = mean(V) and
    dV_j = mean over the queries' dO (uniform weights over all Lk keys)."""
    q, k, v, bias, scale = (a.astype(np.float32) if isinstance(a, np.ndarray) else a
                            for a in _inputs(3, 64, 48, 2, 8, seed=7))
    do = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    got = l64_forward(q, k, v, bias, scale)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(axis=0), got[1].shape),
                               rtol=0, atol=1e-6)
    _, _, dv = l64_backward(q, k, v, bias, do, scale)
    np.testing.assert_allclose(dv[1], np.broadcast_to(do[1].sum(axis=0) / 48, dv[1].shape),
                               rtol=0, atol=1e-5)


def test_softmax_sum64_is_torch_softmax_order_for_up_to_32_keys():
    """With 32 keys or fewer, slots 32 to 63 hold zeros and the sum is the
    warp instance's tree over 32 slots (pairs 16 apart, then 8, 4, 2, 1)."""
    rng = np.random.default_rng(0)
    for lk in (1, 7, 27, 32):
        e = np.zeros((L64, 5), dtype=np.float32)
        e[:lk] = rng.uniform(size=(lk, 5)).astype(np.float32)
        t = [(e[l] + e[l + 16]) + (e[l + 8] + e[l + 24]) for l in range(8)]
        for gap in (4, 2, 1):
            for l in range(gap):
                t[l] = t[l] + t[l + gap]
        np.testing.assert_array_equal(softmax_sum64(e), t[0])
