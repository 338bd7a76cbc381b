"""The shard planner of the port (``parallel/planner.py``, its own numpy copy)
against the JAX package's, bit for bit.

The cases of ``tests/test_planner.py``: each schema goes through both
packages' ``expected_shard_loads``, ``plan_field_order`` and
``plan_capacity``, and every output (loads, vocab order, layout, padded
rows, capacities) must be equal, not close: the two run the same numpy
operations in the same order. The planned FeatureSet then feeds the
port's models.
"""

import numpy as np
import pytest
import torch

from ml_function_tpu.features.schema import FeatureSet as JFeatureSet
from ml_function_tpu.features.schema import SeqSpec as JSeqSpec
from ml_function_tpu.features.schema import SparseSpec as JSparseSpec
from ml_function_tpu.parallel import planner as jplanner
from ml_function_tpu_torch.features.schema import FeatureSet, SeqSpec, SparseSpec
from ml_function_tpu_torch.models import get_model
from ml_function_tpu_torch.parallel import planner

torch.set_num_threads(1)


def _both(sparse, seq=()):
    """The same schema in both packages' FeatureSet."""
    return (FeatureSet(sparse=tuple(SparseSpec(*a, **k) for a, k in sparse),
                       seq=tuple(SeqSpec(*a, **k) for a, k in seq)),
            JFeatureSet(sparse=tuple(JSparseSpec(*a, **k) for a, k in sparse),
                        seq=tuple(JSeqSpec(*a, **k) for a, k in seq)))


def _skewed():
    # two big cold vocabs followed by many tiny hot ones: uniform blocks put
    # every tiny vocab on the last shard
    return _both([((f"big{i}", 1000), {"dim": 4}) for i in range(2)]
                 + [((f"tiny{i}", 10), {"dim": 4}) for i in range(10)])


def _shared():
    return _both([(("item", 500), {"vocab_name": "item_id", "dim": 4}),
                  (("other", 50), {"dim": 4}),
                  (("item2", 500), {"vocab_name": "item_id", "dim": 4})])


def _seq_hot():
    return _both([(("big0", 50), {"dim": 4}), (("big1", 50), {"dim": 4})],
                 [(("hist", 4), {"max_len": 50, "dim": 4})])


def _one(n=100):
    return _both([(("a", n), {"dim": 4})])


SCHEMAS = {"skewed": _skewed, "shared": _shared, "seq_hot": _seq_hot, "one": _one}


def _same_plan(a, b):
    assert a.vocab_order == b.vocab_order
    assert a.feature_set.vocab_layout == b.feature_set.vocab_layout
    assert a.feature_set.min_table_rows == b.feature_set.min_table_rows
    assert a.feature_set.total_vocab == b.feature_set.total_vocab
    assert a.feature_set.vocab_offsets == b.feature_set.vocab_offsets
    np.testing.assert_array_equal(a.loads_before, b.loads_before)
    np.testing.assert_array_equal(a.loads_after, b.loads_after)
    assert a.imbalance_before == b.imbalance_before
    assert a.imbalance_after == b.imbalance_after


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
@pytest.mark.parametrize("n_shards", [2, 4])
def test_plan_field_order_matches_jax(schema, n_shards):
    fs, jfs = SCHEMAS[schema]()
    _same_plan(planner.plan_field_order(fs, n_shards),
               jplanner.plan_field_order(jfs, n_shards))


def test_plan_balances_skewed_schema():
    fs, _ = _skewed()
    plan = planner.plan_field_order(fs, 2)
    assert plan.imbalance_after <= plan.imbalance_before
    assert plan.imbalance_after < 1.2
    assert [s.name for s in plan.feature_set.sparse] == [s.name for s in fs.sparse]
    assert plan.feature_set.total_vocab >= fs.total_vocab


def test_plan_places_seq_only_vocab_in_its_zone():
    fs, _ = _seq_hot()
    plan = planner.plan_field_order(fs, 2)
    assert plan.vocab_order[0] == "hist"
    offs = plan.feature_set.vocab_offsets
    cap = -(-plan.feature_set.total_vocab // 2)
    assert offs["hist"] // cap not in {offs["big0"] // cap, offs["big1"] // cap}


@pytest.mark.parametrize("freq", ["uniform", "half", "zero", "power"])
def test_expected_shard_loads_match_jax(freq):
    fs, jfs = _one()
    f = {"uniform": None, "half": np.r_[np.ones(50), np.zeros(50)],
         "zero": np.zeros(100), "power": 1.0 / np.arange(1, 101)}[freq]
    kw = {} if f is None else {"freq": {"a": f}}
    got = planner.expected_shard_loads(fs, 2, **kw)
    np.testing.assert_array_equal(got, jplanner.expected_shard_loads(jfs, 2, **kw))
    assert np.isclose(got.sum(), 1.0)
    if freq == "half":
        assert np.isclose(got[0], 1.0) and np.isclose(got[1], 0.0)


@pytest.mark.parametrize("ids", [64, 4096, 100_000])
@pytest.mark.parametrize("skew", [False, True])
def test_plan_capacity_matches_jax(ids, skew):
    fs, jfs = _skewed()
    freq = ({s.name: 1.0 / np.arange(1, s.vocab_size + 1) ** 1.2 for s in fs.sparse}
            if skew else None)
    got = planner.plan_capacity(fs, 4, ids, freq=freq)
    assert got == jplanner.plan_capacity(jfs, 4, ids, freq=freq)
    assert 1 <= got <= -(-ids // 4)


def test_unplanned_data_feeds_planned_model():
    """Only table rows move: the unplanned table's rows copied into the
    planned layout give the same logits for the same (unplanned) batch."""
    fs, _ = _skewed()
    plan = planner.plan_field_order(fs, 2)
    rng = np.random.default_rng(0)
    batch = {"dense": np.zeros((16, 0), np.float32),
             "sparse": rng.integers(1, 10, (16, len(fs.sparse))).astype(np.int32)}
    m0 = get_model("fm", fs, device="cpu")
    m1 = get_model("fm", plan.feature_set, device="cpu")
    with torch.no_grad():
        for key in ("table", "linear"):
            src, dst = getattr(m0.embedding, key), getattr(m1.embedding, key)
            for name, size in fs.vocabs:
                a, b = fs.vocab_offsets[name], plan.feature_set.vocab_offsets[name]
                dst[b:b + size] = src[a:a + size]
        m1.bias.copy_(m0.bias)
    np.testing.assert_array_equal(m0(batch)[0].detach().numpy(),
                                  m1(batch)[0].detach().numpy())
