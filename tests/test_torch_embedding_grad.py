"""The merge-scatter embedding gradient and the sequence lookups: the port
(ml_function_tpu_torch) against the JAX package on the CPU.

``dense_grad_reference`` and the CPU backward of ``fused_gather`` are held
to the JAX ``dense_grad_from_updates`` (its Pallas merge-scatter in
interpret mode) at the shapes and the hot row of
tests/test_embedding_grad.py, within 1e-5: both sum each id's cotangents in
f32, in another order. So is ``merge_scatter_reference``, the plain version
of the kernel's own contract (int32 ids sorted stably, the sort's
permutation, the cotangents unsorted and read through it), also on a pad
id that takes a quarter of the ids, whose run crosses several of the
kernel's 256-entry chunks. ``FusedEmbedding.seq``, ``l2_from_seq``,
``l2_loss`` and the pools take the JAX table through the bridge and are held
to the JAX functions within 1e-6 relative (a gather and sums of squares).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_function_tpu.features.synthetic import make_behavior_data as jax_make
from ml_function_tpu.ops import embedding as jemb
from ml_function_tpu.ops.kernels.embedding_grad import dense_grad_from_updates
from ml_function_tpu_torch.bridge import params_from_numpy
from ml_function_tpu_torch.features.synthetic import make_behavior_data
from ml_function_tpu_torch.ops import embedding as temb
from ml_function_tpu_torch.ops.kernels import embedding_grad as teg

torch.set_num_threads(1)

# (V, N, D) of tests/test_embedding_grad.py, then its hot row
CASES = [(1000, 4096, 8, False), (530, 256, 4, False), (100, 2000, 16, False),
         (5000, 64, 8, False), (64, 3000, 8, True)]
# a history's pad id: a quarter of 3,000 ids, a run across several chunks
PAD = (700, 3000, 8, "pad")
IDS = [f"V{v}-N{n}-D{d}" + ("-hot" if h is True else "") for v, n, d, h in CASES]


def _case(v, n, d, hot):
    rng = np.random.default_rng(v + n)
    if hot is True:
        return np.full(n, 7, np.int32), np.ones((n, d), np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    if hot == "pad":
        ids[rng.random(n) < 0.25] = 0
    return ids, rng.normal(size=(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_side():
    return {c: np.asarray(dense_grad_from_updates(
        *(jnp.asarray(a) for a in _case(*c)), c[0])) for c in CASES + [PAD]}


@pytest.mark.parametrize("case", CASES + [PAD], ids=IDS + ["V700-N3000-D8-pad"])
def test_merge_scatter_reference_matches_jax(jax_side, case):
    """The kernel's contract: the cotangents stay unsorted and are read
    through the stable sort's permutation of the int32 ids."""
    v = case[0]
    ids, ct = (torch.from_numpy(a) for a in _case(*case))
    s_ids, order = teg._sort(ids.long())
    assert s_ids.dtype == torch.int32 and order.dtype == torch.int64
    np.testing.assert_array_equal(s_ids.numpy(), np.sort(ids.numpy(), kind="stable"))
    np.testing.assert_array_equal(order.numpy(), np.argsort(ids.numpy(), kind="stable"))
    if case is PAD:
        assert int((s_ids == 0).sum()) > 2 * teg.CHUNK    # crosses chunk boundaries
    got = teg.merge_scatter_reference(s_ids, order, ct, v)
    assert got.shape == (v, ct.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_side[case], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_dense_grad_matches_jax(jax_side, case):
    v = case[0]
    ids, ct = (torch.from_numpy(a) for a in _case(*case))
    want = jax_side[case]
    got = teg.dense_grad_reference(ids, ct, v)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the autograd Function's CPU backward is the plain version
    table = torch.zeros(v, ct.shape[1], requires_grad=True)
    teg.merge_scatter_launches = 0
    rows = teg.fused_gather(table, ids.long())
    (rows * ct).sum().backward()
    assert teg.merge_scatter_launches == 0
    np.testing.assert_allclose(table.grad.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_gather_forward_is_the_rows():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(200, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 200, 512))
    np.testing.assert_array_equal(teg.fused_gather(table, ids).numpy(),
                                  table.numpy()[ids.numpy()])


def test_dense_grad_of_no_ids_is_zero():
    got = teg.dense_grad_reference(torch.zeros(0, dtype=torch.int64),
                                   torch.zeros(0, 8), 17)
    assert got.shape == (17, 8) and not got.any()


# ---------------------------------------------------------------------------
# sequence lookups, their L2 and the pools


@pytest.fixture(scope="module")
def behavior():
    """The JAX FusedEmbedding (no linear table), its params and a batch."""
    fs, data = jax_make(n_rows=32, n_items=30, n_cates=6, seq_len=8, embed_dim=4)
    fe = jemb.FusedEmbedding(fs, with_linear=False)
    params = jax.tree_util.tree_map(np.asarray, fe.init(jax.random.PRNGKey(3)))
    return fs, data, fe, params


def _port(behavior):
    _, data, _, params = behavior
    tfs, tdata = make_behavior_data(n_rows=32, n_items=30, n_cates=6, seq_len=8,
                                    embed_dim=4)
    fe = temb.FusedEmbedding(tfs, with_linear=False)
    params_from_numpy(fe, params)
    return fe, tdata


def _rel(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["hist_item", "hist_cate"])
def test_seq_lookup_and_l2_match_jax(behavior, name):
    _, data, fe, params = behavior
    tfe, tdata = _port(behavior)
    ids = data["seq"][name]
    want_rows, want_mask = fe.seq(params, name, jnp.asarray(ids))
    with torch.no_grad():
        rows, mask = tfe.seq(name, torch.from_numpy(tdata["seq"][name]))
    assert rows.shape == (32, 8, 4) and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    assert not rows[~mask].any()        # pad rows are zeroed
    _rel(tfe.l2_from_seq(name, rows).item(), fe.l2_from_seq(name, want_rows))


def test_l2_loss_matches_jax(behavior):
    _, data, fe, params = behavior
    tfe, tdata = _port(behavior)
    want = fe.l2_loss(params, jnp.asarray(data["sparse"]),
                      {k: jnp.asarray(v) for k, v in data["seq"].items()})
    with torch.no_grad():
        got = tfe.l2_loss(torch.from_numpy(tdata["sparse"]),
                          {k: torch.from_numpy(v) for k, v in tdata["seq"].items()})
    _rel(got.item(), want)


@pytest.mark.parametrize("pool", ["masked_sum_pool", "masked_mean_pool"])
def test_pools_match_jax(pool):
    rng = np.random.default_rng(4)
    seq = rng.normal(size=(6, 5, 3)).astype(np.float32)
    mask = rng.uniform(size=(6, 5)) > 0.4
    mask[2] = False                     # an empty history: mean over max(0, 1)
    want = getattr(jemb, pool)(jnp.asarray(seq), jnp.asarray(mask))
    got = getattr(temb, pool)(torch.from_numpy(seq), torch.from_numpy(mask))
    _rel(got.numpy(), want)


@pytest.mark.parametrize("flag", [False, True])
def test_only_sequence_lookups_take_the_merge_scatter(behavior, flag, monkeypatch):
    """Under the flag ``seq`` goes through ``fused_gather``; the sparse
    lookups keep ``index_select`` either way, as in the reference."""
    monkeypatch.setattr(temb, "_USE_MERGE_SCATTER", flag)
    calls = []
    real = temb.fused_gather
    monkeypatch.setattr(temb, "fused_gather", lambda *a: calls.append(1) or real(*a))
    tfe, tdata = _port(behavior)
    tfe.sparse(torch.from_numpy(tdata["sparse"]))
    assert not calls
    rows, _ = tfe.seq("hist_item", torch.from_numpy(tdata["seq"]["hist_item"]))
    assert len(calls) == int(flag)
    rows.sum().backward()
    _, data, fe, params = behavior
    want = jax.grad(lambda p: jnp.sum(fe.seq(p, "hist_item", jnp.asarray(
        data["seq"]["hist_item"]))[0]))(params)["table"]
    np.testing.assert_allclose(tfe.table.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
