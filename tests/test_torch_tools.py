"""The port's host-side tools against the JAX package's, on the CPU: eda,
the GBDT harness, TF-IDF stacking and the non-graph half of feature_tool
give the same outputs on seeded frames; feature_tool's graph half
(DeepWalk, word2vec, through the port's ``embedding_pretrain``) gives the
JAX package's items, columns and index, its vectors trained from the
port's own draws."""

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")
pytest.importorskip("sklearn")

from ml_function_tpu.tools import eda as jeda  # noqa: E402
from ml_function_tpu.tools import feature_tool as jft  # noqa: E402
from ml_function_tpu.tools import gbdt as jgbdt  # noqa: E402
from ml_function_tpu.tools import stacking as jstack  # noqa: E402
from ml_function_tpu_torch.tools import eda as teda  # noqa: E402
from ml_function_tpu_torch.tools import feature_tool as tft  # noqa: E402
from ml_function_tpu_torch.tools import gbdt as tgbdt  # noqa: E402
from ml_function_tpu_torch.tools import stacking as tstack  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def df():
    rng = np.random.default_rng(0)
    n = 400
    frame = pd.DataFrame({
        "user": rng.integers(0, 20, n),
        "item": rng.integers(0, 15, n),
        "cate": rng.choice(list("abc"), n),
        "price": rng.uniform(1, 100, n),
        "ts": rng.integers(0, 1000, n),
        "hour": rng.integers(0, 24, n),
    })
    frame.loc[::17, "price"] = np.nan
    frame["label"] = (rng.uniform(size=n) < frame["hour"] / 40).astype(float)
    return frame


def _same(a, b):
    if isinstance(a, (pd.DataFrame, pd.Series)):
        pd.testing.assert_frame_equal(pd.DataFrame(a), pd.DataFrame(b))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_eda_report(df, tmp_path):
    kw = dict(time_col="hour", entity_col="user", category_cols=["cate"])
    got = teda.eda_report(df, **kw, out_dir=str(tmp_path / "t"))
    _same(got, jeda.eda_report(df, **kw))
    assert (tmp_path / "t" / "heatmap.png").stat().st_size > 1000
    _same(teda.rate_by_category(df, "item", min_count=30),
          jeda.rate_by_category(df, "item", min_count=30))


def test_feature_tool_frames(df, tmp_path):
    for fn, args in (("null_count_feature", (["price", "cate"],)),
                     ("cross_features", (["user", "item", "cate"], 2)),
                     ("cross_features", (["user", "item", "cate"], 3)),
                     ("count_features", (["user", "cate"],)),
                     ("stat_features", ("user", ["price", "ts"])),
                     ("time_interval_seq", ("user", "ts")),
                     ("ctr_table", ("cate",)),
                     ("ctr_table", ("price", "label", 5))):
        _same(getattr(tft, fn)(df.copy(), *args), getattr(jft, fn)(df.copy(), *args))
    _same(tft.reduce_mem_usage(df.copy()), jft.reduce_mem_usage(df.copy()))
    assert tft.user_item_edgelist(df, "user", "item", "ts") == \
        jft.user_item_edgelist(df, "user", "item", "ts")
    tft.save_pickle({"a": 1}, str(tmp_path / "p.pkl"))
    assert jft.load_pickle(str(tmp_path / "p.pkl")) == {"a": 1}


def test_feature_tool_graph_half_raises(df):
    """The graph half runs (it raised before graph pretraining came to the
    port): the DeepWalk item embeddings cover the JAX package's items at
    the asked width, and the word2vec aggregates of a frame with an empty
    row have its columns and index; the trainers default to the card."""
    kw = dict(dim=8, num_walks=4, walk_length=6)
    got = tft.item_embeddings_from_sequences(df, "user", "item", "ts", device="cpu", **kw)
    want = jft.item_embeddings_from_sequences(df, "user", "item", "ts", **kw)
    assert sorted(got) == sorted(want)
    assert all(v.shape == (8,) and np.isfinite(v).all() for v in got.values())
    seqs = pd.DataFrame({"s": ["a|b", np.nan, "b|c|a", "c"]}, index=[3, 5, 7, 9])
    agg = tft.seq_embedding_aggregates(seqs, "s", device="cpu")
    ref = jft.seq_embedding_aggregates(seqs, "s")
    assert list(agg.columns) == list(ref.columns) and agg.index.equals(ref.index)
    assert (agg.loc[5] == 0).all() and np.isfinite(agg.to_numpy()).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tft.seq_embedding_aggregates(seqs, "s")


@pytest.fixture
def one_thread():
    """sklearn's OpenMP pool at one thread: at its default (a thread a core)
    the histogram GBDT spins its threads against the other test workers'
    (on 8 cores under 6 xdist workers this test took 477–572 s, against
    under a second alone at one thread)."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(1):
        yield


def test_gbdt(tmp_path, one_thread):
    rng = np.random.default_rng(1)
    n = 400
    x = rng.normal(size=(n, 4))
    y = (x[:, 0] + 0.5 * x[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(int)
    kw = dict(n_folds=3, estimator_kw={"max_iter": 40})
    t = tgbdt.GBDTModel(**kw).fit(x, y, feature_names=list("abcd"))
    j = jgbdt.GBDTModel(**kw).fit(x, y, feature_names=list("abcd"))
    _same(t.oof_, j.oof_)
    _same(t.predict_proba(x), j.predict_proba(x))
    assert t.auc(y) == j.auc(y) and t.f1_at_threshold(y) == j.f1_at_threshold(y)
    _same(t.feature_importance(x, y, n_repeats=2), j.feature_importance(x, y, n_repeats=2))
    assert t.useless_features(x, y) == j.useless_features(x, y)
    _same(tgbdt.adversarial_validation(x[:200], x[200:]),
          jgbdt.adversarial_validation(x[:200], x[200:]))
    tl = tgbdt.GBDTLRModel(n_estimators=20, max_depth=3).fit(x, y)
    jl = jgbdt.GBDTLRModel(n_estimators=20, max_depth=3).fit(x, y)
    _same(tl.predict_proba(x), jl.predict_proba(x))


def test_tfidf_stacking():
    rng = np.random.default_rng(2)
    n = 200
    y = rng.integers(0, 2, n)
    texts = ["|".join(f"t{int(v)}" for v in rng.integers(0, 30, 6)) + ("|hot" if l else "")
             for l in y]
    panel = lambda m: [("lr", m.LogisticRegression(max_iter=200)),  # noqa: E731
                       ("nb", m.MultinomialNB())]
    t = tstack.TfidfStacker(n_folds=3, panel=panel(tstack)).fit(texts, y)
    j = jstack.TfidfStacker(n_folds=3, panel=panel(jstack)).fit(texts, y)
    _same(t.oof_, j.oof_)
    assert t.oof_auc_ == j.oof_auc_ and t.oof_auc_ > 0.9
    _same(t.predict_proba(texts[:20]), j.predict_proba(texts[:20]))
