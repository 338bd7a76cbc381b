"""Tests of the port that need the CUDA card; here they skip.

The field-attention kernels are held to their plain versions at the shapes
chip_smoke.py checks: AutoInt's (B 4096, L 27, H 2, Dh 16), the gate's
two edges, DSIN's sessions (B 16,384, L 8, H 2, Dh 8) and DMIN's refiner
(B 4096, L 64, H 2, Dh 8), with a random key mask and one batch row whose keys are all
masked, where the weights are uniform over all Lk keys. Each direction is
also held to its plain version, and to its own bits on a rerun, at the
edges of its three instances (L from 1 to 65 either side of the warp
instances' 32 and the L-64 instances' 64, H 1 to 9, Dh 4 to 64, B not a
multiple of a block's batch rows), the block instance also at the shapes
the others take (the backward's at the L-64 ones), the L-64 instances also
captured into a CUDA graph at DMIN's shape, and a CPU test checks which
instance each shape takes. The (AU)GRU forward's
two instances are held to the plain version at the backward's shapes, at
DIEN's and at H 13 with a ragged B, and must give the same bits as each
other wherever both take H (H ≤ 16). The (AU)GRU and
merge-scatter kernels are held to theirs at DIEN's shapes and the edges
chip_smoke.py checks (a row masked at every step carries h0; no ids, all ids
equal, ids at V − 1, runs that cross the kernel's chunks, a width D that is
not a multiple of 4), and must give the same bits on a second run. The CIN
backward is held to its plain version also at xDeepFM's two layers at
B 4096, and three runs must give the same bits.

The flash-attention kernels are held to their plain versions at SIM's
flash-ESU shape (B 8, H 2, Lq = Lk = 16,384, Dh 8, the key mask of a
hard-searched stream) and at ragged edges (causal with Lq ≠ Lk, Dh from 1
to 64, Lq 1, a batch row whose keys are all masked, which gets mean(V), and
the tensor-core tiles' edges: Lq, Lk not multiples of 8 or 16, Lk < 8), and
all three must give the same bits on a second run. The three split-TF32
kernels are also held to the plain versions in f64 at (2, 2, 2048, 2048)
for Dh 8 and 64, within 1e-5 of max|f64|, with a shrink toward zero of at
most 2^-22 of the mean |value|.

This file imports nothing of JAX, so it also runs on a machine with the card
and without JAX, where tests/conftest.py (which imports JAX) and the
repository's pytest options are left out:

    python3 -m pytest --noconftest -o addopts="" -q tests/test_torch_cuda.py

The kernels are held against their plain versions with rtol 1e-3 and
atol 1e-3·max|ref|: the rounding sites are the same, only the f32 summation
order differs. A train step on the card is held to the same step on the
CPU by the relative norm of each gradient's error, at 1e-3: a layer-1 input
of the CIN that lies within an f32 ulp of a bf16 rounding boundary rounds
one bf16 ulp (2^-8) apart on the two devices, and a gradient summed with
cancellation over the batch (the CIN head's) carries that into single
elements well past 1e-3 of the tensor's largest; the embedding gradient's
atomic adds also change its summation order from run to run.
"""

import numpy as np
import pytest
import torch

from ml_function_tpu_torch.features.synthetic import make_criteo_like
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.ops.kernels import cin as tcin
from ml_function_tpu_torch.ops.kernels import embedding_grad as teg
from ml_function_tpu_torch.ops.kernels import field_attention as tfa
from ml_function_tpu_torch.ops.kernels import flash_attention as tfl
from ml_function_tpu_torch.ops.kernels import gru as tgru
from ml_function_tpu_torch.tools import cin_numerics
from ml_function_tpu_torch.train.loop import make_train_step
from ml_function_tpu_torch.train.optimizers import make_optimizer

torch.set_num_threads(1)

RTOL = 1e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    want = want.detach().cpu().numpy()
    np.testing.assert_allclose(got.detach().cpu().numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("d,b,h,f,o", [
    (4, 200, 5, 5, 100),    # ragged B and O
    (3, 77, 37, 3, 130),    # odd H, O past one 128-wide tile
    (2, 256, 1, 1, 8),      # one field, one row of w1
    (8, 256, 26, 26, 128),  # the first CIN layer of xDeepFM at B 256
    (8, 4096, 26, 26, 128),  # xDeepFM's two layers at B 4096
    (8, 4096, 128, 26, 128),
])
def test_cin_kernel_matches_plain_version(card, d, b, h, f, o):
    gen = torch.Generator(device=card).manual_seed(0)
    xk = torch.randn(d, b, h, device=card, generator=gen)
    x0 = torch.randn(d, b, f, device=card, generator=gen)
    w1 = torch.randn(h, f * o, device=card, generator=gen) * 0.1
    before = tcin.cin_fwd_launches
    got = tcin.cin_layer_t(xk, x0, w1)
    torch.cuda.synchronize()
    assert tcin.cin_fwd_launches == before + 1
    _close(got, tcin.cin_layer_t_reference(xk, x0, w1))


# The CIN forward against f64 of the same bf16 operands at xDeepFM's two
# layers at B 4096 (tools/cin_numerics.py): the largest error (of max|y64|)
# and the shrink toward zero (mean of err · sign(y64) over mean |y64|) that
# the earlier mma.sync kernel read on the card, by H; the wgmma kernel is
# held to 1.25 times each (PERF.md).
CIN_MMA_SYNC_NUMERICS = {26: (2.1226e-07, -2.1063e-08), 128: (2.8831e-07, -9.4467e-08)}


@pytest.mark.parametrize("h", sorted(CIN_MMA_SYNC_NUMERICS))
def test_cin_kernel_does_not_shrink(card, h):
    """The tensor cores sum each field's product in f32 and truncate; a
    kernel that chained more of the sum through them, or folded x0 into a
    bf16 operand, would err more and pull y toward zero by more."""
    got = cin_numerics.measure(tcin, (8, 4096, h, 26, 128))
    print(f"H {h}: {got}")
    max_err, shrink = CIN_MMA_SYNC_NUMERICS[h]
    assert got["max_err"] <= 1.25 * max_err
    assert abs(got["shrink"]) <= 1.25 * abs(shrink)


def test_cin_kernel_refuses_what_it_does_not_take(card):
    xk = torch.zeros(2, 256, 3, device=card)
    x0 = torch.zeros(2, 256, 3, device=card)
    w1 = torch.zeros(3, 3 * 128, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tcin.cin_layer_t(xk.transpose(0, 1), x0, w1)
    with pytest.raises(ValueError, match="float32"):
        tcin.cin_layer_t(xk.double(), x0, w1)
    with pytest.raises(ValueError, match="shapes"):
        tcin.cin_layer_t(xk, x0[:, :100].contiguous(), w1)
    with pytest.raises(ValueError, match="dy_t"):
        tcin.cin_layer_t_backward(xk, x0, w1,
                                  torch.zeros(2, 256, 64, device=card))
    # an input that requires grad is taken: the backward runs the kernel
    w = w1.clone().requires_grad_()
    before = tcin.cin_bwd_launches
    tcin.cin_layer_t(xk, x0, w).sum().backward()
    torch.cuda.synchronize()
    assert tcin.cin_bwd_launches == before + 1 and w.grad.shape == w1.shape


def test_model_on_the_card_matches_the_cpu(card):
    fs, data = make_criteo_like(n_rows=256, n_dense=4, n_sparse=6,
                                vocab_size=50, embed_dim=4, seed=1)
    kw = dict(cin_hidden=(128, 128), hidden=(16, 8))
    on_cpu = get_model("xdeepfm", fs, device="cpu",
                       generator=torch.Generator().manual_seed(0), **kw)
    on_card = get_model("xdeepfm", fs,
                        generator=torch.Generator().manual_seed(0), **kw)
    assert on_card.embedding.table.device.type == "cuda"
    before = tcin.cin_fwd_launches
    with torch.inference_mode():
        want, _, want_aux = on_cpu(data)
        got, _, got_aux = on_card(data)
    assert tcin.cin_fwd_launches == before + 2
    _close(got, want)
    _close(got_aux["emb_l2"], want_aux["emb_l2"])


def _bwd_inputs(card, d, b, h, f, o):
    gen = torch.Generator(device=card).manual_seed(1)
    return (torch.randn(d, b, h, device=card, generator=gen),
            torch.randn(d, b, f, device=card, generator=gen),
            torch.randn(h, f * o, device=card, generator=gen) * 0.1,
            torch.randn(d, b, o, device=card, generator=gen))


@pytest.mark.parametrize("d,b,h,f,o", [
    (4, 200, 5, 5, 100),    # ragged B and O
    (3, 77, 37, 3, 130),    # odd H, O past one 128-wide tile
    (2, 300, 200, 3, 128),  # H past one 128-wide slice of dxk (the wide instance)
    (2, 300, 180, 3, 128),  # the same on the block instance (Hp 192 at F 3)
    (2, 256, 1, 1, 8),      # one field, one row of w1
    (8, 256, 26, 26, 128),  # the first CIN layer of xDeepFM at B 256
    (8, 4096, 26, 26, 128),   # xDeepFM's two CIN layers at the path's B 4096
    (8, 4096, 128, 26, 128),
])
def test_cin_bwd_kernel_matches_plain_version(card, d, b, h, f, o):
    xk, x0, w1, dy = _bwd_inputs(card, d, b, h, f, o)
    before = tcin.cin_bwd_launches
    got = tcin.cin_layer_t_backward(xk, x0, w1, dy)
    torch.cuda.synchronize()
    assert tcin.cin_bwd_launches == before + 1
    for g, w in zip(got, tcin.cin_layer_t_backward_reference(xk, x0, w1, dy)):
        _close(g, w)


@pytest.mark.parametrize("h", [26, 128])
def test_cin_bwd_dw_is_the_same_on_every_run(card, h):
    """dW is a split-K sum with fixed partials and no atomics; dxk and dx0
    are fixed-order sums too: three runs give the same bits."""
    xk, x0, w1, dy = _bwd_inputs(card, 8, 4096, h, 26, 128)
    first = tcin.cin_layer_t_backward(xk, x0, w1, dy)
    for _ in range(2):
        again = tcin.cin_layer_t_backward(xk, x0, w1, dy)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


# (D, B, H, F, O): F6's CIN shapes at a reduced B (H 384, H 512 and the F-39
# edge take both wide instances), then a small ragged shape forced through
# the wide instances
CIN_WIDE_SHAPES = [(8, 512, 384, 26, 128), (8, 512, 512, 26, 128), (2, 1000, 1024, 39, 128)]


@pytest.mark.parametrize("d,b,h,f,o", CIN_WIDE_SHAPES + [(3, 77, 70, 5, 130)])
def test_cin_wide_instances_match_plain_version(card, d, b, h, f, o):
    xk, x0, w1, dy = _bwd_inputs(card, d, b, h, f, o)
    wide = (d, b, h, f, o) not in CIN_WIDE_SHAPES
    fi = "cin_fwd_wide" if wide else tcin.forward_instance(h, f)
    bi = "cin_bwd_wide" if wide else tcin.backward_instance(h, f)
    assert (fi, bi) == ("cin_fwd_wide", "cin_bwd_wide")
    tcin.instance_launches.clear()
    y = tcin._launch_fwd(xk, x0, w1, instance=fi)
    runs = [tcin.cin_layer_t_backward(xk, x0, w1, dy, instance=bi) for _ in range(3)]
    torch.cuda.synchronize()
    assert tcin.instance_launches == {fi: 1, bi: 3}
    _close(y, tcin.cin_layer_t_reference(xk, x0, w1))
    for g, w in zip(runs[0], tcin.cin_layer_t_backward_reference(xk, x0, w1, dy)):
        _close(g, w)
    assert all(torch.equal(a, c) for again in runs[1:] for a, c in zip(runs[0], again))


def test_cin_instances_give_the_same_bits_where_both_run(card):
    """At H 176 (F 26), the widest H of the block backward's 128-row tiles,
    both instances of each direction take the shape; they form U_f in the
    same k order, so their outputs are the same bits."""
    xk, x0, w1, dy = _bwd_inputs(card, 8, 512, 176, 26, 128)
    block = tcin._launch_fwd(xk, x0, w1, instance="cin_fwd")
    wide = tcin._launch_fwd(xk, x0, w1, instance="cin_fwd_wide")
    g_block = tcin.cin_layer_t_backward(xk, x0, w1, dy, instance="cin_bwd")
    g_wide = tcin.cin_layer_t_backward(xk, x0, w1, dy, instance="cin_bwd_wide")
    assert torch.equal(block, wide)
    assert all(torch.equal(a, c) for a, c in zip(g_block, g_wide))


# (H, F, forward instance, backward instance): xDeepFM's layers; the block
# backward's last H at F 26 (its 128-row tiles: 768·(Hp + 8) + 83,968 bytes
# of shared memory, Hp ≤ 176) and the block forward's (two weight stages:
# 768·Hp + 128 + 512·F, Hp ≤ 272), where each wide instance becomes the
# faster (tools/cin_instances.py); the F6 shapes; the wide forward's last Hq
# at F 39 (1472), and past it
@pytest.mark.parametrize("h,f,fwd,bwd", [
    (26, 26, "cin_fwd", "cin_bwd"), (128, 26, "cin_fwd", "cin_bwd"),
    (176, 26, "cin_fwd", "cin_bwd"), (177, 26, "cin_fwd", "cin_bwd_wide"),
    (256, 26, "cin_fwd", "cin_bwd_wide"), (272, 26, "cin_fwd", "cin_bwd_wide"),
    (273, 26, "cin_fwd_wide", "cin_bwd_wide"), (384, 26, "cin_fwd_wide", "cin_bwd_wide"),
    (512, 26, "cin_fwd_wide", "cin_bwd_wide"), (1024, 39, "cin_fwd_wide", "cin_bwd_wide"),
    (1472, 39, "cin_fwd_wide", "cin_bwd_wide"), (1473, 39, None, "cin_bwd_wide"),
])
def test_instance_by_shape(card, h, f, fwd, bwd):
    assert tcin.backward_instance(h, f) == bwd
    if fwd is None:
        with pytest.raises(NotImplementedError, match="shared memory"):
            tcin.forward_instance(h, f)
    else:
        assert tcin.forward_instance(h, f) == fwd


@pytest.mark.parametrize("name,hp", [("dlrm", {"bottom": (16,), "top": (32, 16)}),
                                     ("fibinet", {"hidden": (32, 16)})])
def test_dlrm_and_fibinet_on_the_card_match_the_cpu(card, name, hp):
    """A forward and an SGD step from the same weights on both devices; no
    kernel runs (both models' products are tensor operations)."""
    fs, data = make_criteo_like(n_rows=512, n_dense=4, n_sparse=6,
                                vocab_size=50, embed_dim=4, seed=2)
    models = [get_model(name, fs, device=dev, generator=torch.Generator().manual_seed(0),
                        **hp) for dev in ("cpu", card)]
    assert models[1].embedding.table.device.type == "cuda"
    with torch.inference_mode():
        want, _, _ = models[0](data)
        got, _, _ = models[1](data)
    _close(got, want)
    outs = [make_train_step(m, make_optimizer("sgd", 0.1).init(m))(data) for m in models]
    _close(outs[1]["loss"], outs[0]["loss"])
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        err = (q.grad.cpu() - p.grad).norm() / p.grad.norm()
        assert err <= RTOL, err


def test_train_step_on_the_card_matches_the_cpu(card):
    fs, data = make_criteo_like(n_rows=256, n_dense=4, n_sparse=6,
                                vocab_size=50, embed_dim=4, seed=2)
    kw = dict(cin_hidden=(128, 128), hidden=(16, 8))
    models = [get_model("xdeepfm", fs, device=dev,
                        generator=torch.Generator().manual_seed(0), **kw)
              for dev in ("cpu", card)]
    outs = []
    fwd, bwd = tcin.cin_fwd_launches, tcin.cin_bwd_launches
    for m in models:
        # SGD: the step is linear in the gradient, so the tolerance carries
        outs.append(make_train_step(m, make_optimizer("sgd", 0.1).init(m))(data))
    assert tcin.cin_fwd_launches == fwd + 2 and tcin.cin_bwd_launches == bwd + 2
    _close(outs[1]["loss"], outs[0]["loss"])
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        for got, want in ((q.grad, p.grad), (q, p)):
            err = (got.cpu() - want).norm() / want.norm()
            assert err <= RTOL, err


# (B, Lq, Lk, H, Dh, masked): AutoInt's shape, then the gate's two edges,
# then DSIN's sessions at the board's row (B 2048 · 8 sessions of 8) and
# DMIN's refiner at L 64 (exactly 4096 scores: the L-64 instances), FiGNN's
# fields, then AutoInt at the AutoInt paper's 2 heads of 32 and H past 8
# (the wide instances)
FA_SHAPES = [(4096, 27, 27, 2, 16, False), (512, 64, 64, 2, 64, True),
             (300, 1, 4096, 2, 8, True), (16384, 8, 8, 2, 8, True),
             (4096, 64, 64, 2, 8, True), (4096, 26, 26, 2, 4, False),
             (4096, 27, 27, 2, 32, False), (1001, 12, 12, 10, 8, True)]


def _fa_inputs(card, b, lq, lk, h, dh, masked):
    gen = torch.Generator(device=card).manual_seed(3)
    q, do = (torch.randn(b, lq, h, dh, device=card, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, lk, h, dh, device=card, generator=gen) for _ in range(2))
    bias = torch.zeros(b, lk, device=card)
    if masked:
        mask = torch.rand(b, lk, device=card, generator=gen) > 0.3
        mask[:, 0] = True
        mask[1] = False
        bias = torch.where(mask, 0.0, -1e9)
    return q, k, v, bias, do, 1.0 / dh ** 0.5


@pytest.mark.parametrize("b,lq,lk,h,dh,masked", FA_SHAPES)
def test_field_attention_kernels_match_plain_versions(card, b, lq, lk, h, dh, masked):
    q, k, v, bias, do, scale = _fa_inputs(card, b, lq, lk, h, dh, masked)
    fwd, bwd = tfa.field_attn_fwd_launches, tfa.field_attn_bwd_launches
    got = tfa.field_attention(q, k, v, bias, scale)
    grads = tfa.field_attention_backward(q, k, v, bias, do, scale)
    torch.cuda.synchronize()
    assert (tfa.field_attn_fwd_launches, tfa.field_attn_bwd_launches) == (fwd + 1, bwd + 1)
    _close(got, tfa.field_attention_reference(q, k, v, bias, scale))
    for g, w in zip(grads, tfa.field_attention_backward_reference(q, k, v, bias, do, scale)):
        _close(g, w)
    if masked:   # row 1: every key masked, uniform weights over all Lk
        _close(got[1], v[1].mean(dim=0, keepdim=True).expand(lq, -1, -1))


# (B, Lq, Lk, H, Dh, instance): the backward's instances either side of
# the warp instance's limits (L 32, Dh 16, H 8) and of the L-64 instance's
# (L 64 at the same Dh and H), past which the wide instance takes every
# Dh and H up to L 64 and the block instance the rest, B not a multiple of
# a block's batch rows (4 / H) or pairs (64 / L), Dh not a multiple of 4
# (4-byte copies), SIM's top-8 ESU (Dh 4) and AutoInt's L 27, Lq ≠ Lk both
# ways past 32, then DSIN's sessions and DMIN's refiner at their board
# shapes, then the wide instance at AutoInt's 2 heads of 32, the gate's
# Dh-64 edge, 64 queries against one key and H 100
FA_BWD_CASES = [(4097, 27, 27, 2, 16, "warp"), (129, 8, 8, 2, 4, "warp"),
                (7, 1, 1, 1, 8, "warp"), (9, 8, 8, 4, 8, "warp"),
                (5, 32, 32, 1, 16, "warp"), (10, 27, 27, 2, 13, "warp"),
                (6, 8, 32, 4, 8, "warp"), (11, 32, 8, 3, 16, "warp"),
                (6, 33, 33, 2, 16, "l64"), (5, 27, 27, 2, 17, "wide"),
                (3, 64, 64, 4, 64, "wide"), (4, 1, 64, 1, 8, "l64"),
                (3, 8, 8, 9, 8, "wide"), (16384, 8, 8, 2, 8, "warp"),
                (4096, 64, 64, 2, 8, "l64"), (4096, 26, 26, 2, 4, "warp"),
                (3, 64, 64, 8, 16, "l64"), (5, 65, 63, 2, 8, "block"),
                (4, 64, 64, 2, 17, "wide"), (3, 40, 40, 9, 8, "wide"),
                (9, 64, 64, 2, 8, "l64"), (5, 33, 64, 3, 16, "l64"),
                (6, 64, 40, 1, 13, "l64"), (1001, 64, 48, 2, 8, "l64"),
                (4097, 27, 27, 2, 32, "wide"), (513, 64, 64, 2, 64, "wide"),
                (5, 64, 1, 3, 36, "wide"), (7, 12, 12, 100, 8, "wide"),
                (3, 1, 65, 2, 32, "block")]


def _instance_name(kind, direction="bwd"):
    return f"field_attn_{direction}" + {"warp": "_warp", "l64": "_l64", "wide": "_wide",
                                        "block": ""}[kind]


@pytest.mark.parametrize("b,lq,lk,h,dh,kind", FA_BWD_CASES)
def test_field_attention_backward_instance(b, lq, lk, h, dh, kind):
    """The wrapper's choice of backward instance, on meta tensors (no card,
    no memory)."""
    meta = dict(device="meta", dtype=torch.float32)
    q, k = torch.empty(b, lq, h, dh, **meta), torch.empty(b, lk, h, dh, **meta)
    got = tfa.backward_instance(q, k, k, torch.empty(b, lk, **meta))
    assert got == _instance_name(kind)


@pytest.mark.parametrize("b,lq,lk,h,dh,kind", FA_BWD_CASES)
def test_field_attention_backward_matches_plain_version(card, b, lq, lk, h, dh, kind):
    """The instance the wrapper picks and, past the warp instance's limits,
    the block instance (which takes every shape of the gate), with masked
    keys (key 0 kept) and batch row 1 with every key masked (dV_j the mean
    of dO over the queries); a rerun gives the same bits."""
    q, k, v, bias, do, scale = _fa_inputs(card, b, lq, lk, h, dh, True)
    assert tfa.backward_instance(q, k, v, bias) == _instance_name(kind)
    want = tfa.field_attention_backward_reference(q, k, v, bias, do, scale)
    names = {tfa.backward_instance(q, k, v, bias)}
    if kind in ("l64", "wide"):
        names.add("field_attn_bwd")
    for name in names:
        before = tfa.field_attn_bwd_launches
        grads = tfa.field_attention_backward(q, k, v, bias, do, scale, instance=name)
        again = tfa.field_attention_backward(q, k, v, bias, do, scale, instance=name)
        torch.cuda.synchronize()
        assert tfa.field_attn_bwd_launches == before + 2
        for g, w in zip(grads, want):
            _close(g, w)
        _close(grads[2][1], (do[1].sum(dim=0, keepdim=True) / lk).expand(lk, -1, -1))
        assert all(torch.equal(x, y) for x, y in zip(grads, again)), name


@pytest.mark.parametrize("b,lq,lk,h,dh,kind", FA_BWD_CASES)
def test_field_attention_forward_instances_match_plain_version(card, b, lq, lk, h, dh, kind):
    """The instance the wrapper picks and the block instance (which takes
    every shape of the gate) against the plain version, with masked keys
    (key 0 kept) and batch row 1 with every key masked (mean(V)); a rerun
    gives the same bits."""
    q, k, v, bias, _, scale = _fa_inputs(card, b, lq, lk, h, dh, True)
    assert tfa.forward_instance(q, k, v, bias) == _instance_name(kind, "fwd")
    want = tfa.field_attention_reference(q, k, v, bias, scale)
    for name in {tfa.forward_instance(q, k, v, bias), "field_attn_fwd"}:
        before = tfa.field_attn_fwd_launches
        got = tfa.field_attention_forward(q, k, v, bias, scale, instance=name)
        again = tfa.field_attention_forward(q, k, v, bias, scale, instance=name)
        torch.cuda.synchronize()
        assert tfa.field_attn_fwd_launches == before + 2
        _close(got, want)
        _close(got[1], v[1].mean(dim=0, keepdim=True).expand(lq, -1, -1))
        assert torch.equal(got, again), name


def _fa_graph_replays(card, shape, kind):
    """A forward and a backward on the instances ``kind`` captured into one
    CUDA graph (the chained train step's way of running them) and replayed
    into zeroed outputs give the eager calls' bits; the capture counts
    1 + 1 launches."""
    q, k, v, bias, do, scale = _fa_inputs(card, *shape, True)
    assert (tfa.forward_instance(q, k, v, bias), tfa.backward_instance(q, k, v, bias)) == (
        _instance_name(kind, "fwd"), _instance_name(kind))

    def both():
        return (tfa.field_attention_forward(q, k, v, bias, scale),
                *tfa.field_attention_backward(q, k, v, bias, do, scale))

    eager = both()
    torch.cuda.synchronize()
    fwd, bwd = tfa.field_attn_fwd_launches, tfa.field_attn_bwd_launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = both()
    assert (tfa.field_attn_fwd_launches, tfa.field_attn_bwd_launches) == (fwd + 1, bwd + 1)
    for x in outs:
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(outs, eager))
    _close(outs[0], tfa.field_attention_reference(q, k, v, bias, scale))


def test_field_attention_l64_instances_replay_in_a_cuda_graph(card):
    """DMIN's refiner (B 4096, L 64, H 2, Dh 8) on the L-64 instances."""
    _fa_graph_replays(card, (4096, 64, 64, 2, 8), "l64")


def test_field_attention_wide_instances_replay_in_a_cuda_graph(card):
    """AutoInt at the AutoInt paper's 2 heads of 32 (B 4096, L 27) on the
    wide instances."""
    _fa_graph_replays(card, (4096, 27, 27, 2, 32), "wide")


def test_l64_forward_division_gives_the_ieee_quotient(card):
    """``fa::div_rn``, the L-64 forward's e / sum, against the IEEE division
    over 2^30 (e, sum) pairs in its range (``tools/div_rn_check.py``)."""
    from ml_function_tpu_torch.tools import div_rn_check

    assert div_rn_check.mismatches(log2_pairs=30, seed=2) == 0


def test_forward_instances_refuse_what_they_do_not_take(card):
    """A warp instance asked for a shape past its limits launches nothing
    and raises; so does a name that is no instance."""
    q = torch.zeros(2, 33, 2, 8, device=card)
    bias = torch.zeros(2, 33, device=card)
    xw, wh, mask, att, h0, _ = _gru_inputs(card, 8, 5, 17, "tiny")
    fwd, gfwd = tfa.field_attn_fwd_launches, tgru.gru_fwd_launches
    with pytest.raises(RuntimeError, match="field_attn_fwd_warp"):
        tfa.field_attention_forward(q, q, q, bias, 0.25, instance="field_attn_fwd_warp")
    with pytest.raises(ValueError, match="no forward instance"):
        tfa.field_attention_forward(q, q, q, bias, 0.25, instance="field_attn_bwd")
    wide = torch.zeros(2, 33, 2, 17, device=card)
    with pytest.raises(RuntimeError, match="field_attn_fwd_l64"):
        tfa.field_attention_forward(wide, wide, wide, bias, 0.25, instance="field_attn_fwd_l64")
    bwd = tfa.field_attn_bwd_launches
    with pytest.raises(RuntimeError, match="field_attn_bwd_l64"):
        tfa.field_attention_backward(wide, wide, wide, bias, wide, 0.25,
                                     instance="field_attn_bwd_l64")
    with pytest.raises(ValueError, match="no backward instance"):
        tfa.field_attention_backward(q, q, q, bias, q, 0.25, instance="field_attn_fwd")
    long_k = torch.zeros(2, 65, 2, 8, device=card)
    long_bias = torch.zeros(2, 65, device=card)
    with pytest.raises(RuntimeError, match="field_attn_fwd_wide"):
        tfa.field_attention_forward(q, long_k, long_k, long_bias, 0.25,
                                    instance="field_attn_fwd_wide")
    with pytest.raises(RuntimeError, match="field_attn_bwd_wide"):
        tfa.field_attention_backward(q, long_k, long_k, long_bias, q, 0.25,
                                     instance="field_attn_bwd_wide")
    with pytest.raises(RuntimeError, match="gru_fwd_warp"):
        tgru.gru_sequence_forward(xw, wh, mask, att, h0, instance="gru_fwd_warp")
    with pytest.raises(ValueError, match="no forward instance"):
        tgru.gru_sequence_forward(xw, wh, mask, att, h0, instance="gru_bwd")
    torch.cuda.synchronize()
    assert (tfa.field_attn_fwd_launches, tgru.gru_fwd_launches) == (fwd, gfwd)
    assert tfa.field_attn_bwd_launches == bwd


def test_field_attention_kernel_refuses_what_it_does_not_take(card):
    q = torch.zeros(8, 5, 2, 16, device=card)
    bias = torch.zeros(8, 5, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.field_attention(q.transpose(1, 2), q, q, bias, 0.25)
    with pytest.raises(ValueError, match="float32"):
        tfa.field_attention(q.double(), q, q, bias, 0.25)
    with pytest.raises(ValueError, match="float32"):
        tfa.field_attention(q, q, q, bias.half(), 0.25)
    big = torch.zeros(2, 65, 2, 8, device=card)
    with pytest.raises(ValueError, match="gate"):
        tfa.field_attention(big, big, big, torch.zeros(2, 65, device=card), 0.25)
    with pytest.raises(ValueError, match="do"):
        tfa.field_attention_backward(q, q, q, bias, torch.zeros(8, 5, 2, 8, device=card),
                                     0.25)
    # an input that requires grad is taken: the backward runs the kernel
    qq = q.clone().requires_grad_()
    before = tfa.field_attn_bwd_launches
    tfa.field_attention(qq, q, q, bias, 0.25).sum().backward()
    torch.cuda.synchronize()
    assert tfa.field_attn_bwd_launches == before + 1 and qq.grad.shape == q.shape


def test_autoint_on_the_card_matches_the_cpu(card, monkeypatch):
    """AutoInt through the field-attention kernels, forward and one SGD
    step, against the same model on the CPU's plain versions."""
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", "1")
    fs, data = make_criteo_like(n_rows=256, n_dense=4, n_sparse=6,
                                vocab_size=50, embed_dim=4, seed=1)
    models = [get_model("autoint", fs, device=dev,
                        generator=torch.Generator().manual_seed(0))
              for dev in ("cpu", card)]
    fwd, bwd = tfa.field_attn_fwd_launches, tfa.field_attn_bwd_launches
    with torch.inference_mode():
        want, _, _ = models[0](data)
        got, _, _ = models[1](data)
    _close(got, want)
    outs = [make_train_step(m, make_optimizer("sgd", 0.1).init(m))(data) for m in models]
    assert tfa.field_attn_fwd_launches == fwd + 4 and tfa.field_attn_bwd_launches == bwd + 2
    _close(outs[1]["loss"], outs[0]["loss"])
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        if p.grad is None:
            assert q.grad is None
            continue
        err = (q.grad.cpu() - p.grad).norm() / p.grad.norm()
        assert err <= RTOL, err


# (B, L, H, case): DIEN's recurrences at B 4096, then chip_smoke.py's edges
GRU_SHAPES = [(4096, 64, 16, "path"), (300, 7, 64, "ragged"), (1, 1, 8, "tiny")]


def _gru_inputs(card, b, l, h, case):
    gen = torch.Generator(device=card).manual_seed(5)
    xw = torch.randn(b, l, 3 * h, device=card, generator=gen) * 0.5
    wh = torch.randn(h, 3 * h, device=card, generator=gen) / h ** 0.5
    att = torch.rand(b, l, device=card, generator=gen)
    dseq = torch.randn(b, l, h, device=card, generator=gen)
    lo = l // 2 if case == "path" else 1
    lens = torch.randint(lo, l + 1, (b,), device=card, generator=gen)
    mask = (torch.arange(l, device=card)[None, :] < lens[:, None]).float()
    h0 = torch.zeros(b, h, device=card)
    if case == "ragged":
        mask[1] = 0.0
        h0 = torch.randn(b, h, device=card, generator=gen) * 0.5
    return xw, wh, mask, att, h0, dseq


@pytest.mark.parametrize("gate", ["att", "ones"])
@pytest.mark.parametrize("b,l,h,case", GRU_SHAPES)
def test_gru_kernels_match_plain_versions(card, b, l, h, case, gate):
    xw, wh, mask, att, h0, dseq = _gru_inputs(card, b, l, h, case)
    args = (xw, wh, mask, att if gate == "att" else torch.ones_like(att), h0)
    fwd, bwd = tgru.gru_fwd_launches, tgru.gru_bwd_launches
    seq = tgru.gru_sequence(*args)
    grads = tgru.gru_sequence_backward(*args, seq, dseq)
    again = tgru.gru_sequence_backward(*args, seq, dseq)
    torch.cuda.synchronize()
    assert (tgru.gru_fwd_launches, tgru.gru_bwd_launches) == (fwd + 1, bwd + 2)
    _close(seq, tgru.gru_sequence_reference(*args))
    for g, w in zip(grads, tgru.gru_sequence_backward_reference(*args, seq, dseq)):
        _close(g, w)
    assert torch.equal(grads[1], again[1])       # dwh: fixed partials, no atomics
    if case == "ragged":                         # row 1 is masked at every step
        assert torch.equal(seq[1], h0[1].expand(l, -1))


# (B, L, H): each side of the backward's two instances (H 16 | 17), H 1,
# SIM flash-ESU's B 8, ragged B and L; row 1 is masked at every step
GRU_BWD_SHAPES = [(37, 9, 1), (8, 64, 8), (8, 64, 16), (101, 13, 16), (101, 13, 32),
                  (101, 13, 33), (45, 11, 64)]


@pytest.mark.parametrize("b,l,h", GRU_BWD_SHAPES)
def test_gru_bwd_instances_match_plain_version(card, b, l, h):
    xw, wh, mask, att, h0, dseq = _gru_inputs(card, b, l, h, "ragged")
    args = (xw, wh, mask, att, h0)
    seq = tgru.gru_sequence_reference(*args)
    before = tgru.gru_bwd_launches
    grads = tgru.gru_sequence_backward(*args, seq, dseq)
    again = tgru.gru_sequence_backward(*args, seq, dseq)
    torch.cuda.synchronize()
    assert tgru.gru_bwd_launches == before + 2
    for g, w in zip(grads, tgru.gru_sequence_backward_reference(*args, seq, dseq)):
        _close(g, w)
    assert torch.equal(grads[1], again[1])       # dwh: fixed partials, no atomics
    # row 1 takes no step: its gradients pass dseq's sum straight to h0
    assert torch.equal(grads[0][1], torch.zeros_like(grads[0][1]))
    assert torch.equal(grads[2][1], torch.zeros_like(grads[2][1]))


# (B, L, H): the backward's shapes, DIEN's recurrences and H 13 (three
# padded units of the warp instance) with a B that is not a multiple of 8
GRU_FWD_SHAPES = GRU_BWD_SHAPES + [(4096, 64, 16), (301, 9, 13)]


@pytest.mark.parametrize("b,l,h", GRU_FWD_SHAPES)
def test_gru_fwd_instances_match_plain_version(card, b, l, h):
    """The instance the wrapper picks and the block instance (which takes
    every H) against the plain version; where both take H (H ≤ 16) their
    seq has the same bits. Row 1, masked at every step, carries h0."""
    xw, wh, mask, att, h0, _ = _gru_inputs(card, b, l, h, "ragged")
    args = (xw, wh, mask, att, h0)
    name = tgru.forward_instance(h)
    assert name == ("gru_fwd_warp" if h <= 16 else "gru_fwd")
    before = tgru.gru_fwd_launches
    seq = tgru.gru_sequence_forward(*args)
    block = tgru.gru_sequence_forward(*args, instance="gru_fwd")
    torch.cuda.synchronize()
    assert tgru.gru_fwd_launches == before + 2
    want = tgru.gru_sequence_reference(*args)
    _close(seq, want)
    _close(block, want)
    assert torch.equal(seq[1], h0[1].expand(l, -1))
    assert torch.equal(seq, block)


def test_gru_kernel_refuses_what_it_does_not_take(card):
    xw, wh, mask, att, h0, _ = _gru_inputs(card, 8, 5, 4, "tiny")
    with pytest.raises(ValueError, match="contiguous"):
        tgru.gru_sequence(xw.transpose(0, 1).contiguous().transpose(0, 1), wh, mask, att, h0)
    with pytest.raises(ValueError, match="float32"):
        tgru.gru_sequence(xw, wh, mask.bool(), att, h0)
    with pytest.raises(ValueError, match="shapes"):
        tgru.gru_sequence(xw, wh, mask[:, :3].contiguous(), att, h0)
    empty = torch.zeros(2, 3, 0, device=card)   # H 0: the only H the kernels refuse
    with pytest.raises(ValueError, match="hidden size"):
        tgru.gru_sequence(empty, torch.zeros(0, 0, device=card), torch.ones(2, 3, device=card),
                          torch.ones(2, 3, device=card), torch.zeros(2, 0, device=card))
    # an input that requires grad is taken: the backward runs the kernel
    w = wh.clone().requires_grad_()
    before = tgru.gru_bwd_launches
    tgru.gru_sequence(xw, w, mask, att, h0).sum().backward()
    torch.cuda.synchronize()
    assert tgru.gru_bwd_launches == before + 1 and w.grad.shape == wh.shape


# (B, L, H): F6's wide shapes at a reduced B: DIEN's recurrences at kd 128
# and 256, H 65 (the wide instances' first) and H 1100 (five units a thread)
GRU_WIDE_SHAPES = [(512, 64, 128), (512, 16, 256), (300, 7, 65), (37, 5, 1100)]


@pytest.mark.parametrize("gate", ["att", "ones"])
@pytest.mark.parametrize("b,l,h", GRU_WIDE_SHAPES)
def test_gru_wide_instances_match_plain_version(card, b, l, h, gate):
    """Past H 64 both directions take their wide instances: the forward
    gives the plain version's bits, the backward is within its bars and the
    same bits on a rerun; row 1, masked at every step, carries h0."""
    xw, wh, mask, att, h0, dseq = _gru_inputs(card, b, l, h, "ragged")
    args = (xw, wh, mask, att if gate == "att" else torch.ones_like(att), h0)
    tgru.instance_launches.clear()
    seq = tgru.gru_sequence_forward(*args)
    grads = tgru.gru_sequence_backward(*args, seq, dseq)
    again = tgru.gru_sequence_backward(*args, seq, dseq)
    torch.cuda.synchronize()
    assert tgru.instance_launches == {"gru_fwd_wide": 1, "gru_bwd_wide": 2}
    assert torch.equal(seq, tgru.gru_sequence_reference(*args))
    assert torch.equal(seq[1], h0[1].expand(l, -1))
    for g, w in zip(grads, tgru.gru_sequence_backward_reference(*args, seq, dseq)):
        _close(g, w)
    assert all(torch.equal(g, r) for g, r in zip(grads, again))


def test_gru_bwd_wide_partials_are_bounded_by_the_card(card):
    """The wide backward's grid, and so its (H, 3H) dwh partials, stops at
    the blocks the card holds at once: the same count at B 65,536 and
    131,072, no more than 8 blocks (of 256 threads) an SM, and at a small B
    no more than B."""
    lib = tgru._lib("gru_bwd")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for h in (65, 128, 256, 1100, 4000):
        cap = lib.gru_bwd_wide_partials(1 << 16, h)
        assert 1 <= cap <= 8 * sms and lib.gru_bwd_wide_partials(1 << 17, h) == cap
        assert 1 <= lib.gru_bwd_wide_partials(5, h) <= 5
    assert lib.gru_bwd_wide_partials(4096, 64) < 0   # H 64 is the block instance's


def _hist_ids(card, n, v, seed):
    """n ids like a flattened history: about a quarter the pad id 0."""
    gen = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randint(1, v, (n,), device=card, generator=gen)
    return torch.where(torch.rand(n, device=card, generator=gen) < 0.25, 0, ids)


def _crossing_ids(card):
    """Runs of 1 to 700 ids, shuffled: sorted, they cross one, two and three
    of the kernel's 256-entry chunks at odd offsets."""
    lens = torch.tensor([1, 255, 256, 257, 513, 700, 3, 40], device=card)
    ids = torch.repeat_interleave(torch.arange(100, 900, 100, device=card), lens)
    gen = torch.Generator(device=card).manual_seed(5)
    return ids[torch.randperm(ids.numel(), device=card, generator=gen)]


# (case, D): DIEN's lookups are D 8 (16-byte loads); D 5 takes the scalar loads
@pytest.mark.parametrize("case,d", [("history", 8), ("all_equal", 8), ("empty", 8),
                                    ("last_row", 8), ("crossing", 8), ("crossing", 5)])
def test_merge_scatter_matches_plain_version(card, case, d):
    """The kernel's contract: int32 ids sorted stably, the sort's
    permutation, ct unsorted and read through it; against the plain version
    of that contract, and the same bits on every run."""
    v = 5202
    ids = {"history": lambda: _hist_ids(card, 262_144, v, 6),
           "all_equal": lambda: torch.full((262_144,), 17, device=card),
           "empty": lambda: torch.zeros(0, dtype=torch.int64, device=card),
           "last_row": lambda: torch.randint(v - 3, v, (4096,), device=card),
           "crossing": lambda: _crossing_ids(card)}[case]()
    gen = torch.Generator(device=card).manual_seed(7)
    ct = torch.randn(ids.numel(), d, device=card, generator=gen)
    s_ids, order = teg._sort(ids)
    before = teg.merge_scatter_launches
    got = teg.merge_scatter(s_ids, order, ct, v)
    again = teg.merge_scatter(s_ids, order, ct, v)
    whole = teg.dense_grad_from_updates(ids, ct, v)
    torch.cuda.synchronize()
    assert teg.merge_scatter_launches == before + 3
    assert torch.equal(got, again) and torch.equal(got, whole)   # no atomics
    want = teg.merge_scatter_reference(s_ids, order, ct, v)
    if case == "empty":
        assert got.shape == (v, d) and not got.any()
    else:
        _close(got, want)
    if case == "all_equal":
        assert not got[:17].any() and not got[18:].any()   # written once, zeros elsewhere


def test_merge_scatter_refuses_what_it_does_not_take(card):
    ids = torch.arange(8, device=card)
    ct = torch.zeros(8, 4, device=card)
    s_ids, order = teg._sort(ids)
    with pytest.raises(ValueError, match="contiguous"):
        teg.merge_scatter(s_ids, order, ct.t().contiguous().t(), 10)
    with pytest.raises(ValueError, match="float32"):
        teg.merge_scatter(s_ids, order, ct.double(), 10)
    with pytest.raises(ValueError, match="int32"):
        teg.merge_scatter(s_ids.long(), order, ct, 10)
    with pytest.raises(ValueError, match="int64"):
        teg.merge_scatter(s_ids, order.int(), ct, 10)
    with pytest.raises(ValueError, match="int32 ids"):
        teg.merge_scatter(s_ids, order, ct, 2 ** 31)
    table = torch.zeros(10, 4, device=card, requires_grad=True)
    before = teg.merge_scatter_launches
    teg.fused_gather(table, ids).sum().backward()
    torch.cuda.synchronize()
    assert teg.merge_scatter_launches == before + 1
    assert torch.equal(table.grad[:8], torch.ones(8, 4, device=card))
    assert not table.grad[8:].any()


def test_dien_on_the_card_matches_the_cpu(card, monkeypatch):
    """DIEN on the kernel route with the merge-scatter flag, forward and one
    SGD step, against the same model on the CPU's plain versions."""
    from ml_function_tpu_torch.features.synthetic import make_behavior_data
    from ml_function_tpu_torch.ops import embedding
    monkeypatch.setattr(embedding, "_USE_MERGE_SCATTER", True)
    fs, data = make_behavior_data(n_rows=256, n_items=30, n_cates=6, seq_len=8,
                                  embed_dim=4, seed=1)
    models = [get_model("dien", fs, device=dev, generator=torch.Generator().manual_seed(0),
                        hidden=(16, 8)) for dev in ("cpu", card)]
    for m in models:
        m.gru1.kernel = m.gru2.kernel = "pallas"
    counts = lambda: (tgru.gru_fwd_launches, tgru.gru_bwd_launches,  # noqa: E731
                      teg.merge_scatter_launches)
    before = counts()
    with torch.inference_mode():
        want, _, _ = models[0](data)
        got, _, _ = models[1](data)
    _close(got, want)
    outs = [make_train_step(m, make_optimizer("sgd", 0.1).init(m))(data) for m in models]
    assert counts() == (before[0] + 4, before[1] + 2, before[2] + 2)
    _close(outs[1]["loss"], outs[0]["loss"])
    # the target-attention MLP's biases get residues of sums that cancel
    # (the softmax over steps does not see a shift of every score): they are
    # held against the norm of the whole attention block's gradient
    attn_norm = torch.cat([p.grad.flatten() for n, p in models[0].named_parameters()
                           if n.startswith("attn.")]).norm()
    for (name, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        scale = attn_norm if name.startswith("attn.") else p.grad.norm()
        err = (q.grad.cpu() - p.grad).norm() / scale
        assert err <= RTOL, (name, err)


# (B, H, Lq, Lk, Dh, causal): SIM's flash-ESU shape, then the edges; row 1 of
# every batch but the first has every key masked. The last three are the
# tensor-core kernels' tile edges: Lq and Lk that are not multiples of 16
# or 8, Lk < 8 (at least 3 valid keys: with one, every weight is 1, dQ and
# dK are exactly zero and both sides hold only rounding noise), and one
# 16-row tile on the causal diagonal.
FLASH_SHAPES = [(8, 2, 16384, 16384, 8, False), (3, 2, 1000, 777, 16, True),
                (2, 2, 600, 900, 64, False), (4, 2, 1, 2000, 8, False),
                (2, 3, 130, 129, 1, True), (2, 1, 70, 300, 20, False),
                (2, 1, 40, 50, 33, True), (2, 1, 17, 5, 8, True),
                (1, 2, 33, 7, 16, False), (2, 2, 16, 16, 8, True)]


def _flash_inputs(card, b, h, lq, lk, dh, path):
    """q, k, v, dO and the key bias of streams of random length, right-padded
    (a hard-searched batch); off the path, batch row 1 fully masked."""
    gen = torch.Generator(device=card).manual_seed(9)
    q, do = (torch.randn(b, h, lq, dh, device=card, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, h, lk, dh, device=card, generator=gen) for _ in range(2))
    lens = torch.randint(lk // 2, lk + 1, (b,), device=card, generator=gen)
    mask = torch.arange(lk, device=card)[None, :] < lens[:, None]
    if not path and b > 1:
        mask[1] = False
    return q, k, v, mask, do


@pytest.mark.parametrize("b,h,lq,lk,dh,causal", FLASH_SHAPES)
def test_flash_kernels_match_plain_versions(card, b, h, lq, lk, dh, causal):
    path = (b, lq) == (8, 16384)
    q, k, v, mask, do = _flash_inputs(card, b, h, lq, lk, dh, path)
    bias = torch.where(mask, 0.0, tfl.NEG_INF)
    scale = 1.0 / dh ** 0.5
    counts = lambda: (tfl.flash_fwd_launches, tfl.flash_bwd_dq_launches,  # noqa: E731
                      tfl.flash_bwd_dkv_launches)
    before = counts()
    o = tfl.flash_attention(q, k, v, mask, causal=causal)
    o2, lse2 = tfl.flash_attention_forward(q, k, v, bias, scale, causal)
    o3, lse3 = tfl.flash_attention_forward(q, k, v, bias, scale, causal)
    o_ref, lse = tfl.flash_attention_reference(q, k, v, bias, scale, causal)
    delta = (do * o_ref).sum(dim=-1)
    args = (q, k, v, bias, lse, do, delta, scale, causal)
    dq = tfl.flash_attention_backward_dq(*args)
    dk, dv = tfl.flash_attention_backward_dkv(*args)
    again = (tfl.flash_attention_backward_dq(*args),
             *tfl.flash_attention_backward_dkv(*args))
    torch.cuda.synchronize()
    assert counts() == (before[0] + 3, before[1] + 2, before[2] + 2)
    _close(o, o_ref)
    live = mask.any(dim=1)
    _close(lse2[live], lse[live])
    assert torch.equal(o, o2) and torch.equal(o2, o3) and torch.equal(lse2, lse3)
    for g, w in zip((dq, dk, dv), tfl.flash_attention_backward_reference(*args)):
        _close(g, w)
    assert all(torch.equal(a, b_) for a, b_ in zip((dq, dk, dv), again))
    if not path and b > 1:     # row 1: every key masked, mean(V) over the Lk keys
        _close(o[1], v[1].mean(dim=1, keepdim=True).expand(-1, lq, -1))


@pytest.mark.parametrize("dh", [8, 64])
def test_tensor_core_flash_kernels_are_f32_accurate(card, dh):
    """The split-TF32 forward, dQ and dK/dV kernels against their plain
    versions in f64, every key valid, lse and δ from the f64 forward: o,
    dq, dk and dv within 1e-5 of max|f64| and lse within 1e-5 absolute, the
    bar of an f32 computation (one-pass TF32 errs by some 3e-4)."""
    gen = torch.Generator(device=card).manual_seed(11)
    b, h, l = 2, 2, 2048
    q, k, v, do = (torch.randn(b, h, l, dh, device=card, generator=gen) for _ in range(4))
    bias = torch.zeros(b, l, device=card)
    scale = dh ** -0.5
    f64 = [t.double() for t in (q, k, v, bias)]
    o64, lse64 = tfl.flash_attention_reference(*f64, scale)
    delta64 = (do.double() * o64).sum(dim=-1)
    dq64, dk64, dv64 = tfl.flash_attention_backward_reference(*f64, lse64, do.double(),
                                                              delta64, scale)
    o, lse = tfl.flash_attention_forward(q, k, v, bias, scale)
    bwd = (q, k, v, bias, lse64.float(), do, delta64.float(), scale)
    dq = tfl.flash_attention_backward_dq(*bwd)
    dk, dv = tfl.flash_attention_backward_dkv(*bwd)
    torch.cuda.synchronize()
    for got, want in ((o, o64), (dq, dq64), (dk, dk64), (dv, dv64)):
        assert (got.double() - want).abs().max() <= 1e-5 * want.abs().max()
    assert (lse.double() - lse64).abs().max() <= 1e-5


@pytest.mark.parametrize("dh", [8, 64])
def test_tensor_core_flash_kernels_do_not_shrink(card, dh):
    """The tensor cores truncate where f32 rounds to nearest; an error with
    the sign of the value would shrink o, dq, dk and dv by one share, which a
    long sum downstream keeps. Their shrink against the plain versions in
    f64 (the mean of err · sign(f64) over mean |f64|) stays within 2^-22,
    four f32 steps at 2^-24, where the plain f32 versions' is printed
    beside it."""
    gen = torch.Generator(device=card).manual_seed(12)
    b, h, l = 2, 2, 2048
    q, k, v, do = (torch.randn(b, h, l, dh, device=card, generator=gen) for _ in range(4))
    bias = torch.zeros(b, l, device=card)
    scale = dh ** -0.5
    f64 = [t.double() for t in (q, k, v, bias)]
    o64, lse64 = tfl.flash_attention_reference(*f64, scale)
    delta64 = (do.double() * o64).sum(dim=-1)
    bwd = (lse64.float(), do, delta64.float(), scale)
    exact = (o64, *tfl.flash_attention_backward_reference(*f64, lse64, do.double(),
                                                          delta64, scale))
    kernels = (tfl.flash_attention_forward(q, k, v, bias, scale)[0],
               tfl.flash_attention_backward_dq(q, k, v, bias, *bwd),
               *tfl.flash_attention_backward_dkv(q, k, v, bias, *bwd))
    plain = (tfl.flash_attention_reference(q, k, v, bias, scale)[0],
             *tfl.flash_attention_backward_reference(q, k, v, bias, *bwd))
    torch.cuda.synchronize()

    def shrink(got, want):
        return (((got.double() - want) * want.sign()).mean() / want.abs().mean()).item()

    got = [shrink(g, w) for g, w in zip(kernels, exact)]
    print(f"Dh {dh}: shrink of o, dq, dk, dv {got}; plain f32 "
          f"{[shrink(g, w) for g, w in zip(plain, exact)]}")
    assert max(abs(x) for x in got) <= 2.0 ** -22


def test_flash_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(2, 2, 5, 8, device=card)
    bias = torch.zeros(2, 5, device=card)
    lse = torch.zeros(2, 2, 5, device=card)
    with pytest.raises(ValueError, match="contiguous"):
        tfl.flash_attention(q.transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="float32"):
        tfl.flash_attention(q.double(), q, q)
    with pytest.raises(ValueError, match="shapes"):
        tfl.flash_attention(q, q[:, :1].contiguous(), q)
    big = torch.zeros(2, 2, 5, 65, device=card)
    with pytest.raises(ValueError, match="head dim"):
        tfl.flash_attention(big, big, big)
    with pytest.raises(ValueError, match="shapes"):
        tfl.flash_attention_backward_dq(q, q, q, bias, lse, q[..., :4].contiguous(), lse, 0.5)
    with pytest.raises(ValueError, match="float32"):
        tfl.flash_attention_backward_dkv(q, q, q, bias, lse.double(), q, lse, 0.5)
    # an input that requires grad is taken: the backward runs both kernels
    qq = q.clone().requires_grad_()
    before = tfl.flash_bwd_dq_launches, tfl.flash_bwd_dkv_launches
    tfl.flash_attention(qq, q, q).sum().backward()
    torch.cuda.synchronize()
    assert (tfl.flash_bwd_dq_launches, tfl.flash_bwd_dkv_launches) == (
        before[0] + 1, before[1] + 1) and qq.grad.shape == q.shape


def test_sim_on_the_card_matches_the_cpu(card, monkeypatch):
    """SIM with hard search over a 600-step stream (the flash route), the
    (AU)GRU kernel route and the merge-scatter flag, forward and one SGD
    step, against the same model on the CPU's plain versions."""
    from ml_function_tpu_torch.features.schema import SeqSpec
    from ml_function_tpu_torch.features.synthetic import make_behavior_data
    from ml_function_tpu_torch.ops import embedding
    monkeypatch.setattr(embedding, "_USE_MERGE_SCATTER", True)
    fs, data = make_behavior_data(n_rows=64, n_items=30, n_cates=6, seq_len=8,
                                  embed_dim=4, seed=1)
    fs = fs.replace(seq=fs.seq + (SeqSpec("hist_long", 31, 600, vocab_name="item", dim=4),))
    rng = np.random.default_rng(2)
    lens = rng.integers(300, 601, 64)
    data["seq"]["hist_long"] = (rng.integers(1, 31, (64, 600))
                                * (np.arange(600)[None, :] < lens[:, None])).astype(np.int32)
    models = [get_model("sim", fs, device=dev, generator=torch.Generator().manual_seed(0),
                        search="hard", hidden=(16, 8), long_behavior=("hist_long",))
              for dev in ("cpu", card)]
    for m in models:
        m.dien.gru1.kernel = m.dien.gru2.kernel = "pallas"
    counts = lambda: (tfl.flash_fwd_launches, tfl.flash_bwd_dq_launches,  # noqa: E731
                      tfl.flash_bwd_dkv_launches, tgru.gru_fwd_launches,
                      teg.merge_scatter_launches)
    before = counts()
    with torch.inference_mode():
        want, _, _ = models[0](data)
        got, _, _ = models[1](data)
    _close(got, want)
    outs = [make_train_step(m, make_optimizer("sgd", 0.1).init(m))(data) for m in models]
    assert counts() == (before[0] + 2, before[1] + 1, before[2] + 1, before[3] + 4,
                        before[4] + 3)
    _close(outs[1]["loss"], outs[0]["loss"])
    attn_norm = {p: torch.cat([q.grad.flatten() for n, q in models[0].named_parameters()
                               if n.startswith(p)]).norm() for p in ("attn.", "dien.attn.")}
    for (name, p), q in zip(models[0].named_parameters(), models[1].parameters()):
        if p.grad is None:       # DIEN's own tower, unused by SIM
            assert q.grad is None and name.startswith("dien.mlp.")
            continue
        scale = next((v for k, v in attn_norm.items() if name.startswith(k)), p.grad.norm())
        err = (q.grad.cpu() - p.grad).norm() / scale
        assert err <= RTOL, (name, err)


def test_checkpoint_round_trip_on_the_card(card, tmp_path):
    """A checkpoint of an xDeepFM trained on the card (the CIN kernels,
    B 256) restores into a fresh model and optimizer on the card with the
    same bits, the card's generator state included, and lands there."""
    from ml_function_tpu_torch.train import checkpoint as ckpt
    from ml_function_tpu_torch.train.loop import TrainState, iter_batches, make_train_step
    from ml_function_tpu_torch.train.optimizers import make_optimizer
    fs, data = make_criteo_like(n_rows=768, n_dense=3, n_sparse=5, vocab_size=50,
                                embed_dim=4)
    hp = dict(cin_hidden=(128, 128), hidden=(16,))
    model = get_model("xdeepfm", fs, device=card, **hp)
    opt = make_optimizer("adam", 1e-2).init(model)
    gen = torch.Generator(device=card).manual_seed(5)
    step = make_train_step(model, opt)
    for b in list(iter_batches(data, 256))[:3]:
        step(b)
        torch.rand(4, device=card, generator=gen)
    want = ckpt.state_arrays(TrainState(model, opt, 3, gen))
    path = ckpt.save_checkpoint(str(tmp_path), TrainState(model, opt, 3, gen))
    fresh = get_model("xdeepfm", fs, device=card,
                      generator=torch.Generator().manual_seed(1), **hp)
    opt2 = make_optimizer("adam", 1e-2).init(fresh)
    gen2 = torch.Generator(device=card).manual_seed(0)
    got, _, where = ckpt.restore_latest(str(tmp_path), TrainState(fresh, opt2, 0, gen2))
    assert where == path and got.step == 3
    assert all(p.is_cuda for p in fresh.parameters())
    assert all(s.is_cuda for st in opt2.state.values() for s in st.values())
    have = ckpt.state_arrays(got)
    assert sorted(have) == sorted(want)
    for k in want:
        assert have[k].tobytes() == want[k].tobytes(), k


# ---------------------------------------------------------------------------
# the chained train step: every registry model's K steps in one CUDA graph

CHAIN = 4
# label → (registry name, data, hyperparameters, batch). Small widths; the
# int8 tables and the sparse-row path's RowTape are left out: make_train_step
# refuses to train the first, and the second is not a train step of a model
CHAINED_MODELS = {
    **{n: (n, "criteo", {}, 256) for n in (
        "lr", "fm", "fnn", "ffm", "fwfm", "pnn", "deepcross", "wide_deep", "deepfm",
        "dcn", "nfm", "xdeepfm", "afm", "autoint", "fibinet", "dlrm", "ccpm", "fgcnn",
        "flen", "onn", "oenn", "fat_deepffm", "fignn", "mlr")},
    "dcn_v2": ("dcn", "criteo", {"version": 2}, 256),
    **{n: (n, "cvr", {}, 256) for n in ("esmm", "mmoe", "ple")},
    **{n: (n, "behavior", {}, 64) for n in (
        "din", "dien", "bst", "seqfm", "dstn", "dmin", "mind", "dts", "mimn", "hpmn",
        "dssm", "deepmcp")},
    "dsin": ("dsin", "behavior", {"session_shape": (2, 4)}, 64),
    "sim": ("sim", "sim", {"search": "hard", "long_behavior": ("hist_long",)}, 16),
    "dicm": ("dicm", "image", {}, 64),
}
# The parity runs take torch.use_deterministic_algorithms, where the
# embedding gradient's index_add_ sums in a fixed order: a replay runs the
# same kernels with the same arguments as the eager steps, so the chained
# run must give the single steps' bits. In the default mode index_add_'s
# atomics reorder its sums from run to run, and a replay's timing reorders
# them otherwise than two eager runs do, so the default mode's chained run
# is held to its capture and its launches.


def _chain_data(kind: str, n_rows: int):
    from ml_function_tpu_torch.features import synthetic
    from ml_function_tpu_torch.features.schema import SeqSpec
    if kind == "criteo":
        return make_criteo_like(n_rows=n_rows, n_dense=4, n_sparse=6, vocab_size=50,
                                embed_dim=8, seed=1)
    if kind == "cvr":
        return synthetic.make_cvr_data(n_rows=n_rows, seed=1)
    if kind == "image":
        return synthetic.make_image_ctr_data(n_rows=n_rows, img_dim=64, seed=1)
    fs, data = synthetic.make_behavior_data(n_rows=n_rows, n_items=30, n_cates=6,
                                            seq_len=8, embed_dim=8, seed=1)
    if kind == "sim":   # a 600-id stream: hard search's ESU takes the flash kernels
        fs = fs.replace(seq=fs.seq + (SeqSpec("hist_long", 31, 600, vocab_name="item",
                                              dim=8),))
        rng = np.random.default_rng(2)
        lens = rng.integers(300, 601, n_rows)
        data["seq"]["hist_long"] = (rng.integers(1, 31, (n_rows, 600))
                                    * (np.arange(600)[None, :] < lens[:, None])
                                    ).astype(np.int32)
    return fs, data


def _chain_model(card, name, fs, hp):
    m = get_model(name, fs, device=card, generator=torch.Generator().manual_seed(0), **hp)
    core = m.dien if name == "sim" else m
    if name in ("dien", "sim"):
        core.gru1.kernel = core.gru2.kernel = "pallas"
    return m


@pytest.mark.parametrize("label", sorted(CHAINED_MODELS))
def test_chained_step_is_one_graph_that_matches_the_single_steps(card, label, monkeypatch):
    """Three groups of 4 steps through the chained step (eager, captured and
    replayed, replayed) against the same 12 single steps, from the same
    weights, SGD with momentum. Under deterministic algorithms: two single
    runs and the chained run give the same bits in every loss and
    parameter. In the default mode the chained run is captured too. Both
    modes: one graph, and the single steps' kernel launches. The
    field-attention and merge-scatter flags are on, DIEN and SIM on the
    (AU)GRU kernels."""
    from ml_function_tpu_torch.ops import embedding
    from ml_function_tpu_torch.ops.kernels import launches
    from ml_function_tpu_torch.train.loop import (iter_batches, make_chained_train_step,
                                                  stack_batches)
    monkeypatch.setenv("ML_FUNCTION_TPU_FIELD_ATTN", "1")
    monkeypatch.setattr(embedding, "_USE_MERGE_SCATTER", True)
    name, kind, hp, batch = CHAINED_MODELS[label]
    fs, data = _chain_data(kind, 3 * CHAIN * batch)
    batches = list(iter_batches(data, batch))

    def run(chained: bool, deterministic: bool):
        model = _chain_model(card, name, fs, hp)
        opt = make_optimizer("sgd", 0.01, momentum=0.9).init(model)
        before = launches.snapshot()
        torch.use_deterministic_algorithms(deterministic)
        try:
            if chained:
                step = make_chained_train_step(model, opt, CHAIN)
                losses = torch.cat([step(stack_batches(batches[i:i + CHAIN]))["loss"]
                                    for i in range(0, len(batches), CHAIN)])
                assert step.graph is not None and step.groups == 3
                # a replay launches what 4 single steps launch
                assert {k: 3 * n for k, n in step.launches.items()} == launches.since(before)
            else:
                step = make_train_step(model, opt)
                losses = torch.stack([step(b)["loss"] for b in batches])
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        assert torch.isfinite(losses).all()
        return losses, [p.detach().clone() for p in model.parameters()], launches.since(before)

    a, b, c = run(False, True), run(False, True), run(True, True)
    for other in (b, c):
        assert other[2] == a[2], (other[2], a[2])
        assert torch.equal(other[0], a[0]), (other[0], a[0])
        assert all(torch.equal(p, q) for p, q in zip(other[1], a[1]))
    assert run(True, False)[2] == a[2]


def test_a_capture_that_fails_names_its_line(card):
    """A step that reads a value back to the host cannot be captured: the
    chained step raises at its second group, naming the line."""
    from ml_function_tpu_torch.train.loop import make_chained_train_step

    class Syncing(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(4, device=card))

        def forward(self, batch, train=False):
            logits = batch["dense"] @ self.w
            if float(logits.sum()) > 1e30:     # a host read on the step's path
                logits = logits * 0
            return logits, {}, {}

    model = Syncing()
    step = make_chained_train_step(model, make_optimizer("sgd", 0.1).init(model), 2)
    group = {"dense": np.ones((2, 8, 4), np.float32), "label": np.ones((2, 8), np.float32)}
    step(group)
    with pytest.raises(RuntimeError, match=r"test_torch_cuda\.py:\d+ \(if float"):
        step(group)
    assert step.graph is None
