"""Embedding shard planner: a frequency-aware table layout.

The port's own copy of ``ml_function_tpu/parallel/planner.py`` (numpy
only), so that both packages plan the same layout bit for bit. A shard's
step cost is taken as the number of batch ids it owns (gather and scatter
time is per row). The fused table is row-sharded in contiguous blocks
(``parallel/embedding.py``), so which vocabs share a block decides each
shard's load: CTR id streams are power-law, and a 10-row vocab and a
10M-row vocab both serve B lookups a step.

``plan_field_order`` assigns vocabs to ``n_shards`` zones with a greedy
least-loaded rule and returns a ``FeatureSet`` whose ``vocab_layout`` pins
each vocab to an explicit row offset: zone z starts at row ``z · R``, and
underfilled zones are padded with dead rows, so the realised shard blocks
equal the planned zones. Only the table layout changes; the specs (and so
the batch's column order and id encoding) stay as they are, so data built
from the unplanned FeatureSet stays valid. ``plan_capacity`` sizes the a2a
buckets from the same statistics (``capacity='auto'`` of the CLI).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..features.schema import FeatureSet
from .embedding import rows_per_shard


def _vocab_lookups(fs: FeatureSet) -> Dict[str, float]:
    """Expected lookups per example per vocab: 1 per sparse field + max_len
    per sequence field (padding rows still cost a gathered row)."""
    out: Dict[str, float] = {}
    for s in fs.sparse:
        out[s.vocab] = out.get(s.vocab, 0.0) + 1.0
    for s in fs.seq:
        out[s.vocab] = out.get(s.vocab, 0.0) + float(s.max_len)
    return out


def expected_shard_loads(fs: FeatureSet, n_shards: int,
                         freq: Optional[Mapping[str, np.ndarray]] = None,
                         cap: Optional[int] = None) -> np.ndarray:
    """Expected ids-owned per example for each of the ``n_shards`` contiguous
    row blocks of the fused table, under the FeatureSet's CURRENT layout
    (``vocab_layout`` when set, else spec order).

    ``freq``: optional per-vocab id-popularity arrays (any positive scale;
    normalized internally — e.g. raw training counts from the encoders).
    Missing or all-zero vocabs are treated as uniform. ``cap`` overrides the
    block size (used to score a planned layout against ITS zone grid)."""
    freq = freq or {}
    lookups = _vocab_lookups(fs)
    r = cap or rows_per_shard(fs.total_vocab, n_shards)
    loads = np.zeros(n_shards)
    offs = fs.vocab_offsets
    for name, size in fs.vocabs:
        off = offs[name]
        f = np.asarray(freq.get(name, np.ones(size)), dtype=np.float64)
        if f.shape[0] != size:
            raise ValueError(f"freq for vocab {name!r} has {f.shape[0]} "
                             f"entries, vocab_size is {size}")
        if f.sum() <= 0:  # degenerate counts -> uniform
            f = np.ones(size)
        cum = np.concatenate([[0.0], np.cumsum(f / f.sum())])
        w = lookups.get(name, 0.0)
        for s in range(n_shards):
            lo = min(max(s * r - off, 0), size)
            hi = min(max((s + 1) * r - off, 0), size)
            loads[s] += w * (cum[hi] - cum[lo])
    return loads


def plan_capacity(fs: FeatureSet, n_shards: int, per_device_ids: int,
                  freq: Optional[Mapping[str, np.ndarray]] = None,
                  safety: float = 1.3) -> int:
    """Derive the a2a per-bucket UNIQUE-id capacity from frequency stats
    (an automatic capacity in place of the worst case N/M).

    Model: each rank's a2a peer slice holds ``S = ceil(per_device_ids /
    n_shards)`` ids drawn i.i.d. from the lookup-weighted id distribution
    (per-vocab ``freq`` arrays, e.g. ``SparseEncoder.id_counts``; uniform
    when absent). Expected uniques landing in shard j's bucket:
    ``U_j = Σ_{rows r in shard j} 1 − (1 − p_r)^S``. Capacity =
    ``safety · max_j (U_j + 3·√U_j)`` (mean + 3σ — unique counts are sums
    of independent indicators, variance ≤ mean), clamped to [1, S].
    Power-law streams give capacities far below S (the dedup win);
    runtime drops stay observable via ``ShardedLookup.overflow_count``."""
    freq = freq or {}
    lookups = _vocab_lookups(fs)
    from .embedding import rows_per_shard as _rps
    r = _rps(fs.total_vocab, n_shards)
    s = -(-per_device_ids // n_shards)
    p = np.zeros(r * n_shards, dtype=np.float64)
    offs = fs.vocab_offsets
    for name, size in fs.vocabs:
        f = np.asarray(freq.get(name, np.ones(size)), dtype=np.float64)
        if f.shape[0] != size or f.sum() <= 0:
            f = np.ones(size)
        p[offs[name]:offs[name] + size] = \
            lookups.get(name, 0.0) * f / f.sum()
    total = p.sum()
    if total <= 0:
        return s
    p /= total
    u = 1.0 - np.power(1.0 - p, s)
    u_j = u.reshape(n_shards, r).sum(axis=1)
    worst = float((u_j + 3.0 * np.sqrt(np.maximum(u_j, 1.0))).max())
    return int(min(max(1, int(np.ceil(worst * safety))), s))


@dataclass(frozen=True)
class ShardPlan:
    feature_set: FeatureSet            # layout-stamped — build the MODEL from it
    vocab_order: Tuple[str, ...]       # realized row order (zone concatenation)
    loads_before: np.ndarray           # expected ids-owned/example per shard
    loads_after: np.ndarray

    @property
    def imbalance_before(self) -> float:
        return float(self.loads_before.max() / max(self.loads_before.mean(),
                                                   1e-12))

    @property
    def imbalance_after(self) -> float:
        return float(self.loads_after.max() / max(self.loads_after.mean(),
                                                  1e-12))


def plan_field_order(fs: FeatureSet, n_shards: int,
                     freq: Optional[Mapping[str, np.ndarray]] = None,
                     max_pad_factor: float = 2.0) -> ShardPlan:
    """Greedy balanced layout: vocabs (sorted by expected load, desc) are
    assigned to the currently least-loaded of ``n_shards`` zones, subject to
    a soft row-capacity cap. Zones are then padded to one common block size
    ``R = max(cap, max zone rows)`` and zone z pinned to rows ``[z·R, …)``
    via ``vocab_layout`` (+ ``min_table_rows = n·R``), so planned zones and
    realized shard blocks coincide EXACTLY — the cost the greedy balanced is
    the cost the layout produces. Whole vocabs move — shared-vocab field
    groups stay intact — and per-id ``freq`` still shapes reported loads.

    ``max_pad_factor`` bounds the HBM cost of that padding: if ``n·R``
    exceeds ``max_pad_factor × raw_rows`` (one vocab dominating the table),
    the plan falls back to the PACKED zone concatenation (no dead rows;
    block boundaries may cut zones) and ``loads_after`` honestly reports the
    realized packed cost."""
    base = fs.replace(vocab_layout=None, min_table_rows=None)
    lookups = _vocab_lookups(base)
    sizes = dict(base.vocabs)
    order_by_load = sorted(sizes, key=lambda v: -lookups.get(v, 0.0))
    raw_rows = base.total_vocab
    cap = rows_per_shard(raw_rows, n_shards)

    zone_load = np.zeros(n_shards)
    zone_rows = np.zeros(n_shards, dtype=np.int64)
    zones: Tuple[list, ...] = tuple([] for _ in range(n_shards))
    for v in order_by_load:
        fits = np.where(zone_rows + sizes[v] <= cap)[0]
        candidates = fits if fits.size else np.arange(n_shards)
        z = int(candidates[np.argmin(zone_load[candidates])])
        zones[z].append(v)
        zone_load[z] += lookups.get(v, 0.0)
        zone_rows[z] += sizes[v]

    r_block = int(max(cap, zone_rows.max()))
    if n_shards * r_block <= max_pad_factor * raw_rows:
        # zone-aligned: zone z occupies exactly block z of the sharded table
        layout = []
        for z, zone in enumerate(zones):
            off = z * r_block
            for v in zone:
                layout.append((v, off))
                off += sizes[v]
        new_fs = fs.replace(vocab_layout=tuple(layout),
                            min_table_rows=n_shards * r_block)
    else:
        # packed: no dead rows; boundaries may cut zones (reported below)
        layout, off = [], 0
        for zone in zones:
            for v in zone:
                layout.append((v, off))
                off += sizes[v]
        new_fs = fs.replace(vocab_layout=tuple(layout), min_table_rows=None)

    new_order = [v for v, _ in new_fs.vocabs]
    assert new_order == [v for zone in zones for v in zone], \
        "realized vocab order diverged from the planned zone concatenation"

    return ShardPlan(
        feature_set=new_fs,
        vocab_order=tuple(new_order),
        loads_before=expected_shard_loads(base, n_shards, freq),
        loads_after=expected_shard_loads(
            new_fs, n_shards, freq,
            cap=rows_per_shard(new_fs.total_vocab, n_shards)),
    )
