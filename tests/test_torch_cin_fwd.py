"""A numpy model of the CIN forward kernel
(``ml_function_tpu_torch/ops/kernels/csrc/cin_fwd.cu``), which runs only
on the card.

The model follows the source index for index: ``w_prep_kernel`` writing
each field's (128, Hp) weight tile as 16-byte chunks in the core-matrix
layout, ``stage_xk`` writing the block's bf16 xk tile in that layout, the
shared-memory matrix descriptors (start address, leading and stride byte
offsets, no swizzle) decoded as the PTX ISA defines the canonical K-major
layout for wgmma, m64n128k16's accumulator fragments (thread, register) →
(row, column), the x0 fold of each field's U in f32 on the CUDA cores and
the epilogue's stores. One block's work is run through it in f64 and held
against Σ_f x0 · (bf16(xk) @ bf16(w1)) in f64 within 1e-12 of max|y|: a
layout whose chunks land one core matrix off, a descriptor field packed
in the wrong bits, or a fragment's row and column swapped misses it by
orders of magnitude. The mbarrier ring that feeds the weight tiles is
modelled as well, with the phase-parity rule of ``mbarrier.try_wait``,
under random interleavings of the producer, the eight consumer warps and
the copies in flight.
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TM = TN = 128
CONSUMERS = 256


def pad16(h):
    return (h + 15) // 16 * 16


def core_offset(row, k, hp):
    return (row >> 3) * 8 * hp + (k >> 3) * 64 + (row & 7) * 8 + (k & 7)


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).bfloat16().double().numpy()


def w_prep(w1, h, f, o):
    """The bf16 weight scratch as ``w_prep_kernel`` writes it (flat)."""
    hp, n_ot = pad16(h), -(-o // TN)
    chunks = TN * (hp // 8)
    wt = np.full(f * n_ot * chunks * 8, np.nan)
    i = np.arange(f * n_ot * chunks)
    tile, rem = i // chunks, i % chunks
    n8, kc, ng = rem & 7, (rem >> 3) % (hp // 8), (rem >> 3) // (hp // 8)
    fi, oc = tile // n_ot, (tile % n_ot) * TN + ng * 8 + n8
    wb = bf16(w1)
    for e in range(8):
        k = kc * 8 + e
        ok = (k < h) & (oc < o)
        v = np.where(ok, wb[np.minimum(k, h - 1), fi * o + np.minimum(oc, o - 1)], 0.0)
        wt[(tile * chunks + rem) * 8 + e] = v
    return wt


def stage_xk(xk_d, b0, h):
    """The block's xk tile as ``stage_xk`` writes it (flat, TM x Hp)."""
    b_total = xk_d.shape[0]
    hp = pad16(h)
    kcs = hp // 8
    tile = np.full(TM * hp, np.nan)
    xb = bf16(xk_d)
    for i in range(TM * kcs):
        r8, kc, rg = i & 7, (i >> 3) % kcs, (i >> 3) // kcs
        row, b = rg * 8 + r8, b0 + rg * 8 + r8
        for e in range(8):
            k = kc * 8 + e
            v = xb[b, k] if b < b_total and k < h else 0.0
            tile[core_offset(row, kc * 8, hp) + e] = v
    return tile


def make_desc(addr, hp):
    """``make_desc``: the 64-bit shared-memory matrix descriptor."""
    return ((addr & 0x3FFFF) >> 4) | ((128 >> 4) << 16) | (((16 * hp) >> 4) << 32)


def read_operand(smem, desc, rows):
    """(rows, 16) as wgmma reads a K-major operand without swizzle from
    ``smem`` (bf16 values indexed by byte address / 2): element (r, k) at
    start + (r % 8) * 16 + (r // 8) * SBO + (k // 8) * LBO + (k % 8) * 2."""
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    assert desc >> 62 == 0          # no swizzle
    r, k = np.meshgrid(np.arange(rows), np.arange(16), indexing="ij")
    addr = start + (r % 8) * 16 + (r // 8) * sbo + (k // 8) * lbo + (k % 8) * 2
    return smem[addr // 2]


def fragment_rows_cols():
    """m64nNk16's accumulator of one warpgroup: thread t's register
    4j + e is (row 16 * (t // 32) + (t % 32) // 4 + 8 * (e // 2),
    column 8j + 2 * (t % 4) + e % 2)."""
    t = np.arange(128)[:, None, None]
    j = np.arange(16)[None, :, None]
    e = np.arange(4)[None, None, :]
    lane = t % 32
    row = 16 * (t // 32) + lane // 4 + 8 * (e // 2)
    col = 8 * j + 2 * (lane % 4) + e % 2
    return np.broadcast_to(row, (128, 16, 4)), np.broadcast_to(col, (128, 16, 4))


def block_model(xk, x0, w1, d, bx, ot):
    """y of block (bx, ot, d) as the kernel forms and stores it: a dict
    (b, o) → value."""
    _, b_total, h = xk.shape
    f = x0.shape[2]
    o = w1.shape[1] // f
    hp, n_ot = pad16(h), -(-o // TN)
    b0 = bx * TM
    wt = w_prep(w1, h, f, o)
    # one flat shared memory: the xk tile at byte 0, then the field's stage
    a_tile = stage_xk(xk[d], b0, h)
    x0s = np.zeros(TM * f)
    n = min(TM, b_total - b0) * f
    x0s[:n] = x0[d, b0:b0 + TM].reshape(-1)[:n]
    rows, cols = fragment_rows_cols()
    out = {}
    for wg in range(2):
        acc = np.zeros((128, 16, 4))
        for fi in range(f):
            stage = wt[(fi * n_ot + ot) * TN * hp:(fi * n_ot + ot + 1) * TN * hp]
            smem = np.concatenate([a_tile, stage])          # A at 0, B at TM * hp * 2
            a_base, b_base = wg * 64 * hp * 2, TM * hp * 2
            u = np.zeros((64, TN))
            for kk in range(hp // 16):                     # from zero, k-steps chained
                a = read_operand(smem, make_desc(a_base + kk * 256, hp), 64)
                b = read_operand(smem, make_desc(b_base + kk * 256, hp), TN)
                u = u + a @ b.T
            xa = x0s[(wg * 64 + rows) * f + fi]             # the fold: x0 of the fragment's row
            acc = acc + xa * u[rows, cols]
        for (t, j, e), v in np.ndenumerate(acc):
            b, c = b0 + wg * 64 + rows[t, j, e], ot * TN + cols[t, j, e]
            if b < b_total and c < o:
                out[(b, c)] = v
    assert not np.isnan(sum(out.values()))
    return out


@pytest.mark.parametrize("d,b,h,f,o", [
    (1, 130, 26, 3, 128),   # xDeepFM's first layer's H, a ragged second block
    (2, 64, 37, 2, 130),    # odd H, O past one tile
    (1, 40, 5, 4, 100),     # H padded to 16, O inside one tile
    (1, 20, 128, 2, 128),   # xDeepFM's second layer's H: 8 k-steps
])
def test_block_model_matches_f64_product(d, b, h, f, o):
    rng = np.random.default_rng(b + h)
    xk = rng.normal(size=(d, b, h)).astype(np.float32)
    x0 = rng.normal(size=(d, b, f)).astype(np.float32)
    w1 = (rng.normal(size=(h, f * o)) * 0.1).astype(np.float32)
    want = np.einsum("dbf,dbfo->dbo", x0.astype(np.float64),
                     (bf16(xk) @ bf16(w1)).reshape(d, b, f, o))
    scale = np.abs(want).max()
    for dd in range(d):
        for bx in range(-(-b // TM)):
            for ot in range(-(-o // TN)):
                for (bb, c), v in block_model(xk, x0, w1, dd, bx, ot).items():
                    assert abs(v - want[dd, bb, c]) <= 1e-12 * scale
    # every (b, o) is stored by exactly one thread of one block
    seen = {}
    for bx in range(-(-b // TM)):
        for ot in range(-(-o // TN)):
            for key in block_model(xk, x0, w1, 0, bx, ot):
                seen[key] = seen.get(key, 0) + 1
    assert len(seen) == b * o and set(seen.values()) == {1}


def test_layouts_are_conflict_free_and_contiguous():
    """Eight consecutive staging threads fill one 128-byte core matrix, so
    a warp's 16-byte stores cover 512 contiguous bytes; a prep thread's
    chunk index is its element offset / 8."""
    for hp in (16, 32, 128):
        kcs = hp // 8
        i = np.arange(32)
        r8, kc, rg = i & 7, (i >> 3) % kcs, (i >> 3) // kcs
        offs = np.array([core_offset(rg[x] * 8 + r8[x], kc[x] * 8, hp) for x in range(32)])
        assert sorted(offs * 2) == list(range(0, 512, 16))
        rem = np.arange(TN * kcs)
        n8, kc, ng = rem & 7, (rem >> 3) % kcs, (rem >> 3) // kcs
        assert np.array_equal(core_offset(ng * 8 + n8, kc * 8, hp), rem * 8)


class Barrier:
    """An mbarrier: arrivals and transaction bytes complete a phase;
    ``try_wait(parity)`` holds once the phase of that parity completed."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self, tx=0):
        self.tx += tx
        self.pending -= 1
        self._check()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._check()

    def try_wait(self, parity):
        return (self.phase & 1) != parity


def run_ring(stages, fields, rng):
    """The producer, 8 consumer warps and the bulk copies, interleaved at
    random; a warp reads a stage from its full barrier's phase to its
    arrival on the empty one. Returns the fields each warp read, in order."""
    full = [Barrier(1) for _ in range(stages)]
    empty = [Barrier(CONSUMERS // 32) for _ in range(stages)]
    data = [None] * stages
    readers = [0] * stages               # warps between their wait and their release
    copies = []                          # (stage, field) in flight
    prod = 0
    cons = [0] * 8
    reading = [None] * 8                 # the field a warp is reading
    read = [[] for _ in range(8)]
    while prod < fields or copies or min(cons) < fields:
        moves = []
        if prod < fields and empty[prod % stages].try_wait(((prod // stages) & 1) ^ 1):
            moves.append("produce")
        if copies:
            moves.append("copy")
        for w in range(8):
            fi = cons[w]
            if reading[w] is not None or (
                    fi < fields and full[fi % stages].try_wait((fi // stages) & 1)):
                moves.append(w)
        assert moves, "deadlock"
        mv = moves[rng.integers(len(moves))]
        if mv == "produce":
            full[prod % stages].arrive(tx=1)
            copies.append((prod % stages, prod))
            prod += 1
        elif mv == "copy":
            s, fi = copies.pop(rng.integers(len(copies)))
            assert readers[s] == 0, "a copy overwrote a stage still being read"
            data[s] = fi
            full[s].complete_tx(1)
        elif reading[mv] is None:        # the wait passed: wgmma reads the stage
            s = cons[mv] % stages
            readers[s] += 1
            reading[mv] = data[s]
        else:                            # wgmma done: release the stage
            s = cons[mv] % stages
            assert data[s] == reading[mv]
            read[mv].append(reading[mv])
            reading[mv] = None
            readers[s] -= 1
            empty[s].arrive()
            cons[mv] += 1
    return read


@pytest.mark.parametrize("stages,fields", [(1, 3), (2, 26), (5, 26), (8, 26), (8, 5)])
def test_weight_ring_hands_every_field_in_order(stages, fields):
    rng = np.random.default_rng(stages * 100 + fields)
    for _ in range(20):
        read = run_ring(stages, fields, rng)
        assert all(r == list(range(fields)) for r in read)
