"""A numpy model of the field-attention forward kernel's warp instance
(``ml_function_tpu_torch/ops/kernels/csrc/field_attn_fwd.cu``:
``field_attn_fwd_warp``), which runs only on the card, and the wrapper's
choice of forward instance.

The model follows the source index for index: a block of ``warp_rows(H)``
batch rows and 32 · rows · H threads, the slabs each thread copies in
(``fa::SlabCol``: 16 bytes or 4 a thread, each (b, l) row ``H · DP + 4``
floats, each head's row padded to DP = 8 or 16 with zeros), the bias, a
warp a (b, h) with lane i on query i, its logits in column i of the warp's
(Lk, Lq | 1) matrix, the row's max, the sum of its exponentials as a tree
over 32 slots (pairs 16 apart, then 8, 4, 2, 1: the order of
``torch.softmax``'s warp butterfly), o_i = Σ_j (e_ij / sum) · v_j written
into q_i's slot of the slab, and the block's copy out. It runs in f64 and
is held to the plain version (``field_attention_reference``) in f64 within
1e-12 of max|ref|: a lane that reads another head's row, a padded column
that is not zero, a logit matrix whose columns overlap, or a slab row
copied to the wrong place misses that by orders of magnitude. (The order of
the sum shows only in f32, on the card: chip_smoke.py and the card tests
hold the kernel to the plain version there.)
"""

import numpy as np
import pytest
import torch

from ml_function_tpu_torch.ops.kernels import field_attention as tfa

torch.set_num_threads(1)

WARP_L, WARP_PAIRS, WARP_MAX_H, WARP_MAX_DH = 32, 4, 8, 16


def warp_rows(h):
    return WARP_PAIRS // h if h < WARP_PAIRS else 1


def slab_stride(h, dp):
    return h * dp + 4


def mat_ld(lq):
    return lq | 1


def warp_smem_floats(lq, lk, h, dp):
    nb, s = warp_rows(h), slab_stride(h, dp)
    return nb * (lq + 2 * lk) * s + (nb * lk + 3) // 4 * 4 + nb * h * lk * mat_ld(lq)


def slabs_in(smem, at, src, b0, nb, l, h, dh, dp, vec, threads):
    """The slab of nb batch rows of a (B, L, H, dh) tensor, copied to
    smem[at:] as the block's threads copy it, each keeping one column
    (``fa::SlabCol``)."""
    w = 4 if vec else 1
    s = slab_stride(h, dp)
    flat = src.reshape(-1)
    base = b0 * l * h * dh
    slab = smem[at:]
    per = h * dp // w
    step = threads // per
    for t in range(threads):
        rl0, rem = divmod(t, per)
        hh, c = rem // (dp // w), w * (rem % (dp // w))
        off, col, live = w * rem, hh * dh + c, c < dh
        for rl in range(rl0, nb * l, step):
            g = base + rl * h * dh + col
            slab[rl * s + off:rl * s + off + w] = flat[g:g + w] if live else 0.0


def slab_out(dst, slab, b0, nb, l, h, dh, dp, vec, threads):
    w = 4 if vec else 1
    s = slab_stride(h, dp)
    flat = dst.reshape(-1)
    base = b0 * l * h * dh
    per = h * dp // w
    step = threads // per
    for t in range(threads):
        rl0, rem = divmod(t, per)
        hh, c = rem // (dp // w), w * (rem % (dp // w))
        if c >= dh:
            continue
        off, col = w * rem, hh * dh + c
        for rl in range(rl0, nb * l, step):
            g = base + rl * h * dh + col
            flat[g:g + w] = slab[rl * s + off:rl * s + off + w]


def warp_instance(q, k, v, bias, scale):
    """o as ``field_attn_fwd_warp`` forms it, in the inputs' float type (f64,
    or f32 with every operation rounded)."""
    ft = q.dtype.type
    scale = ft(scale)
    nbatch, lq, h, dh = q.shape
    lk = k.shape[1]
    dp = 8 if dh <= 8 else 16
    vec = dh % 4 == 0
    rows, s, ld = warp_rows(h), slab_stride(h, dp), mat_ld(lq)
    threads = 32 * rows * h
    o = np.full_like(q, np.nan)
    lanes = np.arange(lq)                           # lanes on a query
    for blk in range(-(-nbatch // rows)):
        b0 = blk * rows
        nb = min(rows, nbatch - b0)
        # one shared-memory array with the kernel's offsets; what no thread
        # writes stays NaN
        smem = np.full(warp_smem_floats(lq, lk, h, dp), np.nan, dtype=q.dtype)
        at_k = rows * lq * s
        at_v = at_k + rows * lk * s
        at_b = at_v + rows * lk * s
        at_m = at_b + (rows * lk + 3) // 4 * 4
        slabs_in(smem, 0, q, b0, nb, lq, h, dh, dp, vec, threads)
        slabs_in(smem, at_k, k, b0, nb, lk, h, dh, dp, vec, threads)
        slabs_in(smem, at_v, v, b0, nb, lk, h, dh, dp, vec, threads)
        smem[at_b:at_b + nb * lk] = bias.reshape(-1)[b0 * lk:(b0 + nb) * lk]
        qs, ks, vs = smem, smem[at_k:], smem[at_v:]
        bs, mats = smem[at_b:], smem[at_m:]
        for warp in range(rows * h):
            bl, hh = divmod(warp, h)
            if bl >= nb:
                continue
            qrow = (bl * lq + lanes) * s + hh * dp        # q_i at qs[qrow + c]
            kh = bl * lk * s + hh * dp                    # key j at kh + j * s
            ai = warp * lk * ld + lanes                   # key j's logit at ai + j * ld
            x = np.stack([qs[qrow + c] for c in range(dp)], axis=1)   # (lanes, DP)
            m = np.full(lq, -np.inf, dtype=q.dtype)
            for j in range(lk):
                y = ks[kh + j * s:kh + j * s + dp]
                d = np.zeros(lq, dtype=q.dtype)
                for c in range(dp):                       # the FMAs in order
                    d = d + x[:, c] * y[c]
                lg = d * scale + bs[bl * lk + j]
                mats[ai + j * ld] = lg
                m = np.maximum(m, lg)
            t = np.zeros((16, lq), dtype=q.dtype)   # the sum in torch.softmax's order
            for sl in range(16):
                for j in (sl, sl + 16):
                    if j < lk:
                        e = np.exp(mats[ai + j * ld] - m)
                        mats[ai + j * ld] = e
                        t[sl] = t[sl] + e
            for gap in (8, 4, 2, 1):
                for sl in range(gap):
                    t[sl] = t[sl] + t[sl + gap]
            total = t[0]
            acc = np.zeros((lq, dp), dtype=q.dtype)
            for j in range(lk):
                a = mats[ai + j * ld] / total
                y = vs[kh + j * s:kh + j * s + dp]
                acc = acc + a[:, None] * y[None, :]
            for c in range(dp):                           # o_i into q_i's slot
                qs[qrow + c] = acc[:, c]
        slab_out(o, qs, b0, nb, lq, h, dh, dp, vec, threads)
    return o


def _inputs(b, lq, lk, h, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, lq, h, dh))
    k = rng.normal(size=(b, lk, h, dh))
    v = rng.normal(size=(b, lk, h, dh))
    mask = rng.uniform(size=(b, lk)) > 0.3
    mask[:, 0] = True
    mask[min(1, b - 1)] = False                 # a batch row whose keys are all masked
    bias = np.where(mask, 0.0, -1e9)
    return q, k, v, bias, 1.0 / np.sqrt(dh)


# (B, Lq, Lk, H, Dh): AutoInt's layers with a ragged last block, its L with
# a ragged Dh (4-byte copies), SIM's top-8 ESU (8, 8, 2, 4), the warp
# instance's edges (L 32 and H 1: four batch rows a block; H 8, Dh 16),
# Lq ≠ Lk both ways, H 3 (one row, three warps)
CASES = [(5, 27, 27, 2, 16), (3, 27, 27, 2, 13), (7, 8, 8, 2, 4), (6, 32, 32, 1, 16),
         (2, 5, 9, 8, 16), (3, 12, 3, 3, 8), (2, 1, 1, 1, 1)]


@pytest.mark.parametrize("b,lq,lk,h,dh", CASES)
def test_warp_instance_model_matches_plain_version_in_f64(b, lq, lk, h, dh):
    q, k, v, bias, scale = _inputs(b, lq, lk, h, dh, seed=b * 1000 + lq * 10 + h)
    want = tfa.field_attention_reference(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                                         scale).numpy()
    got = warp_instance(q, k, v, bias, scale)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.abs(want).max())


def test_warp_instance_model_gives_a_fully_masked_row_uniform_weights():
    """In f32, a logit rounded after the product times scale and again after
    the bias is −1e9 exactly for every masked key whose |product · scale| is
    below 32, half of −1e9's ulp: a batch row whose keys are all masked gets
    uniform weights, so o is mean(V) to f32 accuracy (chip_smoke.py checks
    the same on the card)."""
    q, k, v, bias, scale = (a.astype(np.float32) if isinstance(a, np.ndarray) else a
                            for a in _inputs(3, 27, 27, 2, 16, seed=7))
    got = warp_instance(q, k, v, bias, scale)
    assert got.dtype == np.float32
    want = np.broadcast_to(v[1].mean(axis=0, keepdims=True), got[1].shape)
    np.testing.assert_allclose(got[1], want, rtol=0, atol=1e-6)


def _meta(b, lq, lk, h, dh):
    meta = dict(device="meta", dtype=torch.float32)
    q, k = torch.empty(b, lq, h, dh, **meta), torch.empty(b, lk, h, dh, **meta)
    return q, k, k, torch.empty(b, lk, **meta)


# (Lq, Lk, H, Dh, instance): each limit of the warp instances and one past
# it, then each limit of the L-64 instances (L 64, Dh 16, H 8) and one past
# it, which the wide instances take up to L 64 at any Dh and H (AutoInt at
# the AutoInt paper's 2 heads of 32, the gate's Dh-64 edge, H 9 and 65,535
# at one position), and one position past L 64 either way, and the gate's
# Lk-4096 edge, which the block ones take
INSTANCE_CASES = [(32, 32, 8, 16, "warp"), (1, 1, 1, 1, "warp"), (27, 27, 2, 16, "warp"),
                  (33, 32, 2, 16, "l64"), (32, 33, 2, 16, "l64"), (27, 27, 2, 17, "wide"),
                  (27, 27, 9, 16, "wide"), (64, 64, 2, 64, "wide"), (1, 4096, 2, 8, "block"),
                  (64, 64, 8, 16, "l64"), (65, 63, 2, 8, "block"), (1, 65, 2, 8, "block"),
                  (64, 64, 2, 17, "wide"), (40, 40, 9, 8, "wide"), (27, 27, 2, 32, "wide"),
                  (32, 32, 9, 1, "wide"), (64, 64, 9, 16, "wide"), (1, 1, 65535, 1, "wide"),
                  (65, 63, 2, 32, "block"), (63, 65, 9, 8, "block"), (1, 65, 2, 64, "block")]


@pytest.mark.parametrize("lq,lk,h,dh,kind", INSTANCE_CASES)
def test_forward_instance_by_shape(lq, lk, h, dh, kind):
    """On meta tensors (no card, no memory); the backward takes the same
    limits, by the same predicate."""
    args = _meta(3, lq, lk, h, dh)
    suffix = {"warp": "_warp", "l64": "_l64", "wide": "_wide", "block": ""}[kind]
    assert tfa.forward_instance(*args) == "field_attn_fwd" + suffix
    assert tfa.backward_instance(*args) == "field_attn_bwd" + suffix


@pytest.mark.parametrize("lq,lk,dh", [(65, 64, 8), (8, 8, 65)])
def test_forward_instance_refuses_past_the_gate(lq, lk, dh):
    with pytest.raises(ValueError, match="gate"):
        tfa.forward_instance(*_meta(2, lq, lk, 2, dh))


def test_forward_on_the_cpu_runs_the_plain_version():
    """The wrapper on CPU tensors: the plain version, no launch."""
    q, k, v, bias, scale = (torch.from_numpy(a).float() if isinstance(a, np.ndarray) else a
                            for a in _inputs(4, 27, 27, 2, 16, seed=3))
    before = tfa.field_attn_fwd_launches
    got = tfa.field_attention(q, k, v, bias, scale)
    assert tfa.field_attn_fwd_launches == before
    torch.testing.assert_close(got, tfa.field_attention_reference(q, k, v, bias, scale),
                               rtol=0, atol=0)
