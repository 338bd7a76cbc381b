"""The port's C++ walk engine (``embedding_pretrain/native_walks.py`` over its
own ``native/walk_engine.cpp``) against the JAX package's.

The port builds its copy of the source into ``ml_function_tpu_torch/native/
build/``; the source is the JAX package's byte for byte, so the walks are
the same for the same seed and thread count, bit for bit. A fresh process
that runs the port's walks maps the port's library and never the JAX
package's ``_walk_engine.so``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ml_function_tpu.embedding_pretrain import native_walks as jnw
from ml_function_tpu.embedding_pretrain.graph import from_edges as jax_from_edges
from ml_function_tpu_torch.embedding_pretrain import native_walks as tnw
from ml_function_tpu_torch.embedding_pretrain.graph import from_edges

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _engine():
    """The port's engine, built here; without g++ every test skips."""
    if not tnw.native_available():
        pytest.skip("g++ unavailable")


def _edges(n=60, m=400, seed=0):
    rng = np.random.default_rng(seed)
    return [(f"v{s}", f"v{d}", float(w)) for s, d, w in
            zip(rng.integers(0, n, m), rng.integers(0, n, m), rng.uniform(0.5, 3.0, m))]


@pytest.fixture(scope="module")
def jax_walks():
    """The JAX package's native walks on a weighted random graph (one
    dead-end node), at 1 and 4 threads."""
    edges = _edges() + [("v0", "sink", 1.0)]
    g = jax_from_edges(edges)
    out = {}
    for nt in (1, 4):
        out[("deepwalk", nt)] = jnw.deepwalk_walks_native(g, 5, 12, seed=3, n_threads=nt)
        out[("node2vec", nt)] = jnw.node2vec_walks_native(g, 5, 12, p=0.5, q=2.0, seed=3,
                                                         n_threads=nt)
    return edges, out


def test_walk_engine_source_is_the_jax_packages():
    with open(os.path.join(ROOT, "ml_function_tpu_torch", "native", "walk_engine.cpp"),
              "rb") as f:
        mine = f.read()
    with open(os.path.join(ROOT, "ml_function_tpu", "native", "walk_engine.cpp"), "rb") as f:
        assert mine == f.read()


@pytest.mark.parametrize("kind", ["deepwalk", "node2vec"])
@pytest.mark.parametrize("threads", [1, 4])
def test_native_walks_match_jax(jax_walks, kind, threads):
    """DeepWalk and node2vec (p 0.5, q 2) walks equal the JAX package's for
    the same seed and thread count, and the port's own at another thread
    count."""
    edges, want = jax_walks
    g = from_edges(edges)
    if kind == "deepwalk":
        got = tnw.deepwalk_walks_native(g, 5, 12, seed=3, n_threads=threads)
    else:
        got = tnw.node2vec_walks_native(g, 5, 12, p=0.5, q=2.0, seed=3, n_threads=threads)
    assert got.dtype == np.int32 and got.shape == (5 * g.num_nodes, 12)
    np.testing.assert_array_equal(got, want[(kind, threads)])
    np.testing.assert_array_equal(got, want[(kind, 5 - threads)])
    sink = g.name_to_id["sink"]
    rows = got[(got == sink).any(axis=1)]
    assert len(rows) and all((r[list(r).index(sink):] == sink).all() for r in rows)


def test_port_never_loads_the_jax_library():
    """A process that imports the port alone and walks maps the port's
    build of the engine, not the JAX package's."""
    code = ("from ml_function_tpu_torch.embedding_pretrain import native_walks as nw\n"
            "from ml_function_tpu_torch.embedding_pretrain.graph import from_edges\n"
            "g = from_edges([('a', 'b', 1.0), ('b', 'a', 2.0)])\n"
            "nw.deepwalk_walks_native(g, 2, 4, seed=0, n_threads=1)\n"
            "maps = open('/proc/self/maps').read()\n"
            "print('port' if 'libwalk_engine-' in maps else 'none',\n"
            "      'jax' if '_walk_engine.so' in maps else 'clean')\n"
            "import sys; print(sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "      ('jax', 'ml_function_tpu')))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=120, check=True).stdout.split("\n")
    assert out[0] == "port clean"
    assert out[1] == "[]"
    assert os.path.dirname(tnw.get_lib()._name) == os.path.join(
        ROOT, "ml_function_tpu_torch", "native", "build")
