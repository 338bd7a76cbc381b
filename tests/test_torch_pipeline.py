"""The port's encoders and input pipelines against the JAX package's, on the
CPU: ``SparseEncoder`` (vocab, md5 and FNV hashing), ``DenseEncoder``,
``SeqEncoder``, and the Criteo, behavior and Avazu CSV pipelines with the
pandas and the native engines (the behavior pipeline also with
``session_shape`` and hard search) give the same ``FeatureSet`` field by
field and the same arrays bit for bit."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

pd = pytest.importorskip("pandas")

from ml_function_tpu.features import encoders as jenc  # noqa: E402
from ml_function_tpu.features import pipeline as jpl  # noqa: E402
from ml_function_tpu_torch.features import encoders as tenc  # noqa: E402
from ml_function_tpu_torch.features import pipeline as tpl  # noqa: E402
from ml_function_tpu_torch.features.native_loader import native_available  # noqa: E402

torch.set_num_threads(1)

FIX = Path(__file__).resolve().parent / "fixtures"
CRITEO = str(FIX / "criteo_tiny.txt")
AVAZU = str(FIX / "avazu_tiny.csv")
BEHAVIOR = str(FIX / "behavior_tiny.csv")
needs_gxx = pytest.mark.skipif(not native_available(),
                               reason="g++ toolchain unavailable")


def _same_arrays(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_arrays(a[k], b[k])
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert x.tobytes() == y.tobytes(), k


def _same_fs(a, b):
    """Two packages' FeatureSets, field by field."""
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def _same_result(got, want):
    _same_fs(got[0], want[0])
    _same_arrays(got[1], want[1])


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(0)
    n = 300
    df = pd.DataFrame({
        "a": rng.choice(["x", "y", "z", None], n),
        "b": rng.integers(0, 40, n),
        "d1": rng.normal(size=n),
        "d2": np.where(rng.random(n) < 0.2, np.nan, rng.integers(0, 900, n)),
        "h": ["|".join(str(v) for v in rng.integers(1, 30, rng.integers(0, 9)))
              for _ in range(n)],
    })
    df.loc[5, "h"] = np.nan
    return df


@pytest.mark.parametrize("mode,min_count", [("vocab", 1), ("vocab", 3),
                                            ("hash", 1), ("fnv", 1)])
def test_sparse_encoder(frame, mode, min_count):
    cols = ["a", "b"]
    t = tenc.SparseEncoder(mode=mode, hash_buckets=101, min_count=min_count).fit(frame, cols)
    j = jenc.SparseEncoder(mode=mode, hash_buckets=101, min_count=min_count).fit(frame, cols)
    assert t.vocabs == j.vocabs
    _same_arrays({"x": t.transform(frame, cols)}, {"x": j.transform(frame, cols)})
    for c in cols:
        assert t.vocab_size(c) == j.vocab_size(c)
        _same_arrays({"n": t.id_counts(frame, c)}, {"n": j.id_counts(frame, c)})


def test_hash_helpers():
    vals = np.array(["x", "17", "", "-1", "é"], object)
    for salt in ("C1", "site_id"):
        _same_arrays({"h": tenc._hash_bucket(vals, 997, salt)},
                     {"h": jenc._hash_bucket(vals, 997, salt)})
        _same_arrays({"h": tenc._fnv_bucket(vals, 997, salt)},
                     {"h": jenc._fnv_bucket(vals, 997, salt)})


@pytest.mark.parametrize("log1p", [False, True])
def test_dense_encoder(frame, log1p):
    cols = ["d1", "d2"]
    t = tenc.DenseEncoder(log1p=log1p).fit(frame, cols)
    j = jenc.DenseEncoder(log1p=log1p).fit(frame, cols)
    _same_arrays({"lo": t.mins, "hi": t.maxs, "x": t.transform(frame, cols)},
                 {"lo": j.mins, "hi": j.maxs, "x": j.transform(frame, cols)})


def test_seq_encoder(frame):
    t = tenc.SeqEncoder(max_len=5).fit(frame["h"])
    j = jenc.SeqEncoder(max_len=5).fit(frame["h"])
    assert t.vocab == j.vocab and t.vocab_size == j.vocab_size
    _same_arrays({"x": t.transform(frame["h"])}, {"x": j.transform(frame["h"])})
    shared = {"3": 1, "7": 2}
    _same_arrays({"x": t.transform(frame["h"], shared)},
                 {"x": j.transform(frame["h"], shared)})


@pytest.mark.parametrize("hash_features", [False, True])
def test_criteo_pipeline_pandas(hash_features):
    kw = dict(hash_features=hash_features, hash_buckets=2048, engine="pandas")
    _same_result(tpl.criteo_csv_pipeline(CRITEO, **kw),
                 jpl.criteo_csv_pipeline(CRITEO, **kw))


@needs_gxx
@pytest.mark.parametrize("engine", ["native", "auto"])
def test_criteo_pipeline_native(engine):
    kw = dict(hash_features=True, hash_buckets=2048, engine=engine, embed_dim=4)
    got = tpl.criteo_csv_pipeline(CRITEO, **kw)
    _same_result(got, jpl.criteo_csv_pipeline(CRITEO, **kw))
    assert got[1]["sparse"].shape == (240, 26)
    with pytest.raises(ValueError):
        tpl.criteo_csv_pipeline(CRITEO, engine="native")


@pytest.mark.parametrize("session_shape,hard", [(None, False), (None, True),
                                                ((2, 3), False)])
def test_behavior_pipeline(session_shape, hard):
    kw = dict(seq_len=6, embed_dim=4, session_shape=session_shape,
              with_hard_search=hard)
    _same_result(tpl.behavior_csv_pipeline(BEHAVIOR, **kw),
                 jpl.behavior_csv_pipeline(BEHAVIOR, **kw))


@pytest.mark.parametrize("engine,hash_features,hash_mode", [
    ("pandas", False, "hash"), ("pandas", True, "hash"), ("pandas", True, "fnv"),
    pytest.param("native", True, "hash", marks=needs_gxx)])
def test_avazu_pipeline(engine, hash_features, hash_mode):
    kw = dict(hash_features=hash_features, hash_buckets=1024, engine=engine,
              hash_mode=hash_mode)
    got = tpl.avazu_csv_pipeline(AVAZU, **kw)
    _same_result(got, jpl.avazu_csv_pipeline(AVAZU, **kw))
    if engine == "native":   # the native engine hashes as pandas' 'fnv' mode
        fnv = tpl.avazu_csv_pipeline(AVAZU, hash_features=True, hash_buckets=1024,
                                     engine="pandas", hash_mode="fnv")
        _same_arrays({k: got[1][k] for k in ("sparse", "label")},
                     {k: fnv[1][k] for k in ("sparse", "label")})


def test_avazu_pipeline_max_rows():
    kw = dict(hash_features=True, hash_buckets=1024, max_rows=50)
    _same_result(tpl.avazu_csv_pipeline(AVAZU, **kw),
                 jpl.avazu_csv_pipeline(AVAZU, **kw))
