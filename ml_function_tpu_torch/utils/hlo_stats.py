"""Collective accounting of the sharded step: each collective's kind,
payload bytes and group size, priced with ring wire models and projected
onto weak-scaling efficiency.

Counterpart of ``ml_function_tpu/utils/hlo_stats.py``. PyTorch has no HLO:
the port issues its collectives eagerly, one call at a time, and every one
goes through ``parallel/comm.py``. So the port records them as they are
issued: inside ``record_collectives()`` each primitive of ``comm.py`` adds a
``CollectiveInstr`` (the backward's collectives too, since the
differentiable collectives call the same primitives). The recorder takes
the place of the reference's ``collective_stats_from_text`` and
``compiled_text``, which parse compiled HLO; the port has no text to parse.
Where XLA's combiner merges several all-reduces into one tuple all-reduce,
eager PyTorch issues them apart, so counts can differ from the reference's
while bytes agree.

Wire models per op (ring algorithms, K = the group's size, S = the
recorded bytes), as the reference's:
- all-reduce:          2·(K-1)/K · S   (reduce-scatter + all-gather)
- all-gather:            (K-1)/K · S   (S = the whole gathered output)
- reduce-scatter:        (K-1)/K · S   (S = the whole input)
- all-to-all:            (K-1)/K · S   (each peer keeps its own block)
- collective-permute:              S   (one hop)
- broadcast:                       S   (the sharded checkpoint's restore
                                        agreeing on a step; no step has one)

One difference: a group of one moves nothing, so its wire bytes are 0 (a
collective-permute too). The reference takes ``max(K, 2)`` for groups it
could not parse; the port always knows its group.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional

from ..parallel import comm


@dataclass(frozen=True)
class CollectiveInstr:
    """One collective as issued: its kind (``op``), the bytes of the dtype
    it sends, its group's size and kind ('data', 'model' or 'other')."""

    op: str
    bytes: int
    group_size: int
    group: str = "other"
    dtype: str = ""

    def wire_bytes(self) -> float:
        """Bytes this rank moves over its links under the wire model of
        ``op`` (module docstring)."""
        k = self.group_size
        if k <= 1:
            return 0.0
        if self.op == "all-reduce":
            return 2 * (k - 1) / k * self.bytes
        if self.op in ("all-gather", "reduce-scatter", "all-to-all"):
            return (k - 1) / k * self.bytes
        return float(self.bytes)  # collective-permute (one hop), broadcast


@dataclass
class CollectiveStats:
    """The collectives one rank issued inside a recorder, in order."""

    instrs: List[CollectiveInstr] = field(default_factory=list)

    @property
    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = defaultdict(int)
        for i in self.instrs:
            c[i.op] += 1
        return dict(c)

    @property
    def bytes(self) -> Dict[str, int]:
        b: Dict[str, int] = defaultdict(int)
        for i in self.instrs:
            b[i.op] += i.bytes
        return dict(b)

    @property
    def total_count(self) -> int:
        return len(self.instrs)

    @property
    def total_bytes(self) -> int:
        return sum(i.bytes for i in self.instrs)

    def wire_bytes(self) -> float:
        """This rank's bytes over its links under the ring wire models."""
        return sum(i.wire_bytes() for i in self.instrs)

    def select(self, op: Optional[str] = None, group: Optional[str] = None,
               dtype: Optional[str] = None) -> "CollectiveStats":
        """The records of one kind, group kind and dtype (None: any)."""
        return CollectiveStats([i for i in self.instrs
                                if (op is None or i.op == op)
                                and (group is None or i.group == group)
                                and (dtype is None or i.dtype == dtype)])

    def summary(self) -> Dict[str, Any]:
        return {"counts": self.counts, "bytes": self.bytes,
                "total_count": self.total_count,
                "total_bytes": self.total_bytes}


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveStats]:
    """Within the block, every collective that ``parallel/comm.py`` issues
    on this rank is appended to the yielded ``CollectiveStats``. Recorders
    nest: each active one sees every collective. Recording under CUDA-graph
    capture raises (a replay would issue what the recorder cannot see)."""
    stats = CollectiveStats()

    def rec(op, nbytes, size, kind, dtype):
        stats.instrs.append(CollectiveInstr(op, nbytes, size, kind, dtype))

    comm.RECORDERS.append(rec)
    try:
        yield stats
    finally:
        comm.RECORDERS.remove(rec)


def collective_stats(step: Callable, *args, **kwargs) -> CollectiveStats:
    """The collectives of one call of ``step(*args, **kwargs)`` on this rank:
    the counterpart of the reference's ``collective_stats(fn, *args)``. The
    reference only lowers and compiles its step; this RUNS one step, so the
    state it updates (parameters, optimizer moments, step count) moves by
    one step."""
    with record_collectives() as stats:
        step(*args, **kwargs)
    return stats


# ---------------------------------------------------------------------------
# Link roofline projection
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LinkModel:
    """One H100 SXM5's NVLink 4: 18 links, 900 GB/s in total over both
    directions (NVIDIA H100 Tensor Core GPU data sheet, SXM5 column), so
    450 GB/s a direction. A data-sheet figure, not a measurement: the card
    machine has one H100, and no link to time. The wire models count the
    bytes a rank sends; its sends and receives run at once in the two
    directions, so a rank sends at ``gbps_per_direction``.

    ``latency_s`` is a host call floor, not a link latency: the time of one
    collective's call apart from its bytes. Its default, 0.0786 ms, is the
    median of the seven floors of one NCCL call that ``chip_smoke.py`` phase
    27 (c) measured on NVIDIA H100 80GB HBM3 cards at 700 W (0.0576, 0.0588,
    0.0738, 0.0786, 0.2000, 0.2181 and 0.2640 ms from run to run): a 4-byte
    all-reduce at world size 1, the median of 50 calls each between two
    CUDA events on an otherwise idle card, so it is what the host takes to
    issue the call. A call over links adds their latency to it; pass the
    floor measured on the card at hand (phase 27 (c) prints it)."""

    gbps_per_direction: float = 450.0
    latency_s: float = 7.86e-5

    @property
    def bytes_per_s(self) -> float:
        return self.gbps_per_direction * 1e9

    def comm_s(self, wire_bytes: float, n_collectives: int) -> float:
        """The time of ``n_collectives`` calls moving ``wire_bytes`` in all."""
        return wire_bytes / self.bytes_per_s + n_collectives * self.latency_s


def projected_efficiency(step_time_s: float, wire_bytes_per_step: float,
                         n_collectives: int = 0,
                         link: Optional[LinkModel] = None,
                         overlap: float = 0.0) -> Dict[str, float]:
    """Weak-scaling efficiency of one step, the reference's formula: the
    per-rank batch (and so ``step_time_s``, one card's step) fixed,
    ``wire_bytes_per_step`` from the recorded step at the target mesh.
    ``overlap`` in [0, 1] is the share of the communication hidden behind
    compute (0: all exposed, the pessimistic bound)."""
    link = link or LinkModel()
    t_comm = link.comm_s(wire_bytes_per_step, n_collectives)
    exposed = t_comm * (1.0 - overlap)
    eff = step_time_s / (step_time_s + exposed)
    return {"t_compute_s": step_time_s, "t_comm_s": t_comm,
            "t_comm_exposed_s": exposed, "efficiency": eff}
