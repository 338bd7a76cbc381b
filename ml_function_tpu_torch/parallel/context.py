"""The sharding context: routes the lookups through collectives while a mesh
with a model axis above 1 is active.

Counterpart of ``ml_function_tpu/parallel/context.py``. Models call
``FusedEmbedding.sparse``/``seq`` and ``gather_rows`` unchanged; under
``with sharded_embeddings(mesh): ...`` those lookups read row-sharded
tables through ``parallel/embedding.ShardedLookup`` instead of a local
gather. The same context tells BatchNorm to take the data group's moments
and MMoE to gather its expert blocks over the model group.

``seq_shard`` (SIM's sequence-sharded search) and ``pp_microbatches``
(GPipe) are the reference's flags for ``parallel/longseq.py`` and
``parallel/pipeline.py``, which the port does not have yet: setting either
raises ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

from .mesh import MODEL_AXIS

_state = threading.local()

ITEM_8B = ("the sequence-sharded search (seq_shard) and the pipeline "
           "(pp_microbatches) come with ROADMAP.md Queue 1 item 8b")


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


def refuse_item_8b(seq_shard: bool = False, pp_microbatches: int = 0) -> None:
    if seq_shard or pp_microbatches:
        raise NotImplementedError(ITEM_8B)


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
    derives one from frequencies)."""
    refuse_item_8b(seq_shard, pp_microbatches)
    if mode not in ("psum", "a2a"):
        raise ValueError(f"unknown exchange mode {mode!r}")
    prev = (getattr(_state, "mesh", None), getattr(_state, "mode", "psum"),
            getattr(_state, "compress", None), getattr(_state, "capacity", None))
    _state.mesh, _state.mode = mesh, mode
    _state.compress, _state.capacity = compress, capacity
    try:
        yield
    finally:
        _state.mesh, _state.mode, _state.compress, _state.capacity = prev
