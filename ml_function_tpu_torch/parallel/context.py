"""The sharding context: routes the lookups through collectives while a mesh
with a model axis above 1 is active.

Counterpart of ``ml_function_tpu/parallel/context.py``. Models call
``FusedEmbedding.sparse``/``seq`` and ``gather_rows`` unchanged; under
``with sharded_embeddings(mesh): ...`` those lookups read row-sharded
tables through ``parallel/embedding.ShardedLookup`` instead of a local
gather. The same context tells BatchNorm to take the data group's moments
and MMoE to gather its expert blocks over the model group. ``seq_shard``
routes SIM's soft search through ``parallel/longseq.py`` and
``pp_microbatches`` AutoInt's block stack through ``parallel/pipeline.py``,
as the reference's flags do.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from .mesh import MODEL_AXIS

_state = threading.local()
_DEFAULTS = {"mesh": None, "mode": "psum", "compress": None, "capacity": None,
             "seq_shard": False, "pp_microbatches": 0}


def active_mesh():
    return getattr(_state, "mesh", None)


def model_axis_size() -> int:
    mesh = active_mesh()
    return 1 if mesh is None else mesh.shape.get(MODEL_AXIS, 1)


def exchange_mode() -> str:
    return getattr(_state, "mode", "psum")


def exchange_compress() -> Optional[str]:
    return getattr(_state, "compress", None)


def exchange_capacity() -> Optional[int]:
    return getattr(_state, "capacity", None)


def seq_shard_active() -> bool:
    """True when the long streams' key axes are to be sharded over
    ``model`` (SIM's soft search, ``parallel/longseq.py``)."""
    return bool(getattr(_state, "seq_shard", False))


def pp_microbatches() -> int:
    """> 0 when deep block stacks are to be pipelined over ``model`` with
    this many microbatches (AutoInt, ``parallel/pipeline.py``)."""
    return int(getattr(_state, "pp_microbatches", 0))


@contextlib.contextmanager
def sharded_embeddings(mesh, mode: str = "psum",
                       compress: Optional[str] = None,
                       capacity: Optional[int] = None,
                       seq_shard: bool = False,
                       pp_microbatches: int = 0):
    """``mode``: 'psum' (mask + all-reduce) or 'a2a' (the deduped id
    all-to-all), see ``parallel/embedding.py``. ``compress='bf16'`` ships
    the exchanged rows in bfloat16. ``capacity`` bounds the unique ids of an
    a2a bucket (None: the lossless worst case; ``planner.plan_capacity``
    derives one from frequencies). ``seq_shard=True`` shards the long
    streams' key axes over ``model``; ``pp_microbatches`` > 0 pipelines deep
    block stacks over ``model`` with that many microbatches."""
    if mode not in ("psum", "a2a"):
        raise ValueError(f"unknown exchange mode {mode!r}")
    prev = {k: getattr(_state, k, v) for k, v in _DEFAULTS.items()}
    _state.mesh, _state.mode = mesh, mode
    _state.compress, _state.capacity = compress, capacity
    _state.seq_shard, _state.pp_microbatches = seq_shard, pp_microbatches
    try:
        yield
    finally:
        for k, v in prev.items():
            setattr(_state, k, v)
