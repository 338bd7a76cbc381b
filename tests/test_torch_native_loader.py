"""The port's native loaders against the JAX package's, bit for bit, on the
CPU: ``load_criteo``, ``parse_buffer`` (custom ``sparse_cols``),
``CriteoFileIterator`` (a batch carried across chunks, ``shard=(i, n)``),
``load_avazu``, ``fnv1a64`` and ``py_reference_parse`` on the fixtures and
on a seeded file (the native parse against ``py_reference_parse``: ids
and labels bit for bit, the log1p dense block within one f32 ulp, R12);
``BehaviorFileIterator`` with the native and the Python
engine, with and without ``hist_long``. The port's libraries are built
from its own copies of the C++ sources, never from the JAX package's."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from ml_function_tpu.features import behavior_stream as jbs
from ml_function_tpu.features import native_loader as jnl
from ml_function_tpu_torch import native
from ml_function_tpu_torch.features import behavior_stream as tbs
from ml_function_tpu_torch.features import native_loader as tnl

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(not tnl.native_available(),
                                reason="g++ toolchain unavailable")

FIX = Path(__file__).resolve().parent / "fixtures"
CRITEO = str(FIX / "criteo_tiny.txt")
AVAZU = str(FIX / "avazu_tiny.csv")
BEHAVIOR = str(FIX / "behavior_tiny.csv")


def _same(a, b):
    """Nested dicts of arrays, equal bit for bit (dtype, shape, bytes)."""
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def _seeded_tsv(path, rows=3000, n_dense=13, n_sparse=26, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        dense = [str(int(rng.integers(-2, 5000))) if rng.random() > 0.2 else ""
                 for _ in range(n_dense)]
        sparse = [f"{int(rng.integers(0, 1 << 32)):08x}" if rng.random() > 0.1
                  else "" for _ in range(n_sparse)]
        lines.append("\t".join([str(int(rng.integers(0, 2)))] + dense + sparse))
    Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def _seeded_behavior(path, rows=700, seed=0, long=True):
    rng = np.random.default_rng(seed)
    head = "label,item,cate,hist_item,hist_cate" + (",hist_long" if long else "")
    lines = [head]
    for _ in range(rows):
        n = int(rng.integers(0, 30))
        hist = "|".join(str(int(v)) for v in rng.integers(1, 5000, n))
        cates = "|".join(str(int(v)) for v in rng.integers(1, 90, n))
        row = [str(int(rng.integers(0, 2))), str(int(rng.integers(1, 5000))),
               str(int(rng.integers(1, 90))), hist, cates]
        if long:
            row.append("|".join(str(int(v)) for v in
                                rng.integers(1, 5000, int(rng.integers(0, 90)))))
        lines.append(",".join(row))
    Path(path).write_text("\n".join(lines) + "\n")
    return str(path)


def test_the_port_builds_its_own_copies():
    tbs._get_blib()
    for name in ("criteo_loader", "behavior_loader"):
        src = native.SRC / f"{name}.cpp"
        assert src.exists() and src.parent.parent.name == "ml_function_tpu_torch"
        so = native.library_path(name)
        assert so.parent == native.BUILD and so.name.startswith(f"lib{name}-")
        assert so.exists()    # built by the loaders' first call
    assert str(native.BUILD).startswith(str(Path(tnl.__file__).resolve().parents[1]))
    # the C++ code is the JAX package's, comments aside
    for name in ("criteo_loader", "behavior_loader"):
        strip = lambda p: [ln for ln in Path(p).read_text().splitlines()  # noqa: E731
                           if not ln.lstrip().startswith("//")]
        jax_src = Path(jnl.__file__).resolve().parents[1] / "native" / f"{name}.cpp"
        assert strip(native.SRC / f"{name}.cpp") == strip(jax_src)
    ignored = (Path(__file__).resolve().parents[1] / ".gitignore").read_text().split()
    assert "build/" in ignored and "*.so" in ignored
    # the loaded libraries are the port's, never the JAX package's
    with open("/proc/self/maps") as f:
        maps = f.read()
    assert str(native.library_path("criteo_loader")) in maps
    assert str(native.library_path("behavior_loader")) in maps


@pytest.mark.parametrize("buckets,log1p", [(1 << 20, True), (997, False)])
def test_load_criteo_fixture(buckets, log1p):
    _same(tnl.load_criteo(CRITEO, hash_buckets=buckets, log1p=log1p),
          jnl.load_criteo(CRITEO, hash_buckets=buckets, log1p=log1p))


def test_seeded_file_and_python_reference(tmp_path):
    path = _seeded_tsv(tmp_path / "c.tsv")
    got = tnl.load_criteo(path, hash_buckets=100_000)
    _same(got, jnl.load_criteo(path, hash_buckets=100_000))
    text = Path(path).read_text()
    ref = tnl.py_reference_parse(text, hash_buckets=100_000)
    _same(ref, jnl.py_reference_parse(text, hash_buckets=100_000))
    # the native parse against the Python reference: ids and labels bit for
    # bit; the dense block within one f32 ulp, as the C++ takes log1p in
    # f32 (log1pf) where the reference rounds numpy's f64 log1p (R12)
    _same({k: got[k] for k in ("sparse", "label")},
          {k: ref[k] for k in ("sparse", "label")})
    np.testing.assert_array_max_ulp(got["dense"], ref["dense"], maxulp=1)
    raw = tnl.py_reference_parse(text, hash_buckets=100_000, log1p=False)
    _same(tnl.load_criteo(path, hash_buckets=100_000, log1p=False), raw)


def test_parse_buffer_custom_columns():
    text = Path(CRITEO).read_bytes()
    cols = [f"f{i}" for i in range(26)]
    kw = dict(hash_buckets=4093, sparse_cols=cols, n_threads=3)
    _same(tnl.parse_buffer(text, **kw), jnl.parse_buffer(text, **kw))
    with pytest.raises(ValueError):
        tnl.parse_buffer(text, sparse_cols=cols[:3])


def test_fnv1a64():
    for data in (b"", b"C1:", b"a1b4c210", bytes(range(256))):
        assert tnl.fnv1a64(data) == jnl.fnv1a64(data)
        assert tnl.fnv1a64(data, 12345) == jnl.fnv1a64(data, 12345)


@pytest.mark.parametrize("shard", [None, (0, 3), (2, 3)])
def test_file_iterator_carry_and_shards(tmp_path, shard):
    path = _seeded_tsv(tmp_path / "s.tsv", rows=4000)
    kw = dict(hash_buckets=1009, chunk_bytes=1 << 16, shard=shard)
    got = list(tnl.CriteoFileIterator(path, 96, **kw))
    want = list(jnl.CriteoFileIterator(path, 96, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        _same(a, b)
    # 96 does not divide a 64 KiB chunk's rows: batches straddle chunks
    assert os.path.getsize(path) > 4 * (1 << 16)
    with pytest.raises(ValueError):
        tnl.CriteoFileIterator(path, 8, shard=(3, 3))


def test_load_avazu():
    for buckets in (1 << 20, 1024):
        cols, got = tnl.load_avazu(AVAZU, hash_buckets=buckets)
        jcols, want = jnl.load_avazu(AVAZU, hash_buckets=buckets)
        assert cols == jcols and cols[-2:] == ["hour_of_day", "day"]
        _same(got, want)


@pytest.mark.parametrize("engine", ["native", "python"])
@pytest.mark.parametrize("long_seq_len", [0, 32])
def test_behavior_file_iterator(tmp_path, engine, long_seq_len):
    for path, seq_len in ((BEHAVIOR, 8), (_seeded_behavior(tmp_path / "b.csv"), 20)):
        kw = dict(seq_len=seq_len, long_seq_len=long_seq_len, item_buckets=4099,
                  cate_buckets=97, chunk_bytes=1 << 16, engine=engine)
        got = list(tbs.BehaviorFileIterator(path, 64, **kw))
        want = list(jbs.BehaviorFileIterator(path, 64, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _same(a, b)
        fs, whole = tbs.load_behavior_stream(path, **kw)
        jfs, jwhole = jbs.load_behavior_stream(path, **kw)
        _same(whole, jwhole)
        assert repr(fs) == repr(jfs)
    # the two engines agree with each other as well
    other = "python" if engine == "native" else "native"
    _, a = tbs.load_behavior_stream(BEHAVIOR, seq_len=8, long_seq_len=long_seq_len,
                                    engine=engine)
    _, b = tbs.load_behavior_stream(BEHAVIOR, seq_len=8, long_seq_len=long_seq_len,
                                    engine=other)
    _same(a, b)


def test_encode_int_ids_and_lists():
    ids = np.array([[0, 1, 5, 4098, 4099, 10**9]], np.int64)
    np.testing.assert_array_equal(tbs.encode_int_ids(ids, 4099),
                                  jbs.encode_int_ids(ids, 4099))
    col = np.array(["3|19|2", "", "7", None, "1|2|3|4|5|6"], object)
    np.testing.assert_array_equal(tbs._parse_int_lists(col, 4),
                                  jbs._parse_int_lists(col, 4))
