"""Feature schema: the port's own copy of ``ml_function_tpu/features/schema.py``.

Frozen dataclasses describing dense, sparse and sequence columns, and the
fused-table row layout derived from them (vocab offsets, width groups). The
port keeps its own copy so that it never imports the JAX package; the two
copies must agree, and the parity tests build one schema with each.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class DenseSpec:
    """A continuous feature column (reference ``denseFea``, data_prepare.py:60)."""

    name: str


@dataclass(frozen=True)
class SparseSpec:
    """A categorical feature column (reference ``sparseFea``, data_prepare.py:59).

    vocab_size counts real ids 1..vocab_size-1; id 0 is the padding/unknown slot.
    ``vocab_name`` names the id space; fields with the same ``vocab_name``
    share embedding rows (candidate item vs. behavior item sequence).
    """

    name: str
    vocab_size: int
    vocab_name: Optional[str] = None
    # Dimension of the *cross* (second-order) embedding. The reference default
    # is 8 (data_prepare.py:96). All specs in one FeatureSet must agree — the
    # fused table has one dim.
    dim: int = 8
    emb_l2: float = 1e-8
    trainable: bool = True

    @property
    def vocab(self) -> str:
        return self.vocab_name or self.name


@dataclass(frozen=True)
class SeqSpec:
    """A behavior-sequence feature (reference seq branch of ``sparseFea``;
    built by ``seq_deal``/``sparse_wrap``, data_prepare.py:150-217).

    ``max_len`` is the static padded length. ``vocab_name`` typically points at
    the candidate field's vocab. Sessions (DSIN) are expressed as a seq of
    ``session_num * session_len`` with ``session_shape`` set.
    """

    name: str
    vocab_size: int
    max_len: int
    vocab_name: Optional[str] = None
    dim: int = 8
    emb_l2: float = 1e-8
    trainable: bool = True
    # (session_num, session_len) for DSIN-style session features, else None.
    session_shape: Optional[Tuple[int, int]] = None

    @property
    def vocab(self) -> str:
        return self.vocab_name or self.name


@dataclass(frozen=True)
class FeatureSet:
    """The full input schema handed to every model constructor.

    Equivalent of the reference's ``InputFeature`` (data_prepare.py:39-54), but
    carrying *metadata only* — tensors live in the batch dict, parameters in
    the param tree. Vocab layout for the fused table is derived once here.
    """

    dense: Tuple[DenseSpec, ...] = ()
    sparse: Tuple[SparseSpec, ...] = ()
    seq: Tuple[SeqSpec, ...] = ()
    # Explicit fused-table row layout: ((vocab_name, row_offset), ...) set by
    # the shard planner (parallel/planner.py). ONLY the table layout changes —
    # batch column order is tied to the spec tuples, which a plan never
    # permutes, so data encoded from an unplanned FeatureSet stays valid (the
    # planner footgun of reordering specs is structurally impossible).
    # Offsets may leave gaps (zone padding to shard-block boundaries).
    vocab_layout: Optional[Tuple[Tuple[str, int], ...]] = None
    # Pad the fused table to at least this many rows (planner: n_shards * R
    # so the last zone fills its block and blocks == zones exactly).
    min_table_rows: Optional[int] = None

    def __post_init__(self):
        # Per-feature embedding widths (reference ``sparseFea.cross_unit``
        # is per-feature, data_prepare.py:59, recombined by AlignLayer,
        # core_layer.py:240-257): vocabs may declare different dims. The
        # LARGEST dim is the primary width; primary-dim vocabs share the
        # fused table, and each narrower width group gets its own fused
        # sub-table plus a learned Align projection back to the primary
        # width at lookup time (ops/embedding.py), so models still see one
        # uniform (B, F, D) — the standard vocab-size-scaled-dim trick
        # with the reference's recombination semantics. A vocab shared by
        # several fields must have ONE dim.
        vdims: dict = {}
        for s in list(self.sparse) + list(self.seq):
            prev = vdims.setdefault(s.vocab, s.dim)
            if prev != s.dim:
                raise ValueError(
                    f"vocab {s.vocab!r} declared with dims {prev} and "
                    f"{s.dim} — fields sharing a vocab share its rows, so "
                    "they must share one dim")
        names = [s.name for s in self.dense + self.sparse + self.seq]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate feature names in {names}")
        # vocab_name groups must agree on vocab_size
        sizes: dict = {}
        for s in list(self.sparse) + list(self.seq):
            prev = sizes.setdefault(s.vocab, s.vocab_size)
            if prev != s.vocab_size:
                raise ValueError(
                    f"vocab {s.vocab!r} declared with sizes {prev} and {s.vocab_size}")
        if self.vocab_layout is not None:
            names = [n for n, _ in self.vocab_layout]
            primary = [n for n, _ in self.vocabs]
            if sorted(names) != sorted(primary):
                raise ValueError(
                    f"vocab_layout names {sorted(names)} != primary-width "
                    f"vocabs {sorted(primary)} (narrow width groups have "
                    "their own sub-tables and are not plannable)")
            spans = sorted((off, off + sizes[n], n)
                           for n, off in self.vocab_layout)
            prev_hi, prev_n = 0, None
            for lo, hi, n in spans:
                if lo < prev_hi:
                    raise ValueError(
                        f"vocab_layout rows overlap: {prev_n!r} ends at "
                        f"{prev_hi}, {n!r} starts at {lo}")
                prev_hi, prev_n = hi, n

    # ---- derived layout -------------------------------------------------
    #
    # The fused-table row space (vocabs/total_vocab/vocab_offsets and the
    # sharding/planner machinery on top of it) covers the PRIMARY width
    # group — for uniform-dim FeatureSets (the normal case) that is every
    # vocab and nothing changes. Narrower width groups each get their own
    # sub-table row space (``width_groups``/``aux_vocab_offsets``), owned
    # by FusedEmbedding.

    @property
    def embed_dim(self) -> int:
        """The PRIMARY (largest) embedding width — the uniform activation
        width every model sees after lookup (+Align for narrow groups)."""
        return max((s.dim for s in self.sparse + self.seq), default=0)

    @property
    def mixed_width(self) -> bool:
        return len({s.dim for s in self.sparse + self.seq}) > 1

    @property
    def width_groups(self) -> Mapping[int, Tuple[str, ...]]:
        """dim → vocab names (first-appearance order), all width groups."""
        out: dict = {}
        for s in list(self.sparse) + list(self.seq):
            g = out.setdefault(s.dim, [])
            if s.vocab not in g:
                g.append(s.vocab)
        return {d: tuple(v) for d, v in out.items()}

    def aux_vocab_offsets(self, dim: int) -> Mapping[str, int]:
        """Row offsets inside the width-``dim`` sub-table (narrow groups)."""
        out, off = {}, 0
        sizes = {s.vocab: s.vocab_size
                 for s in list(self.sparse) + list(self.seq)}
        for v in self.width_groups[dim]:
            out[v] = off
            off += sizes[v]
        return out

    def aux_total_vocab(self, dim: int) -> int:
        sizes = {s.vocab: s.vocab_size
                 for s in list(self.sparse) + list(self.seq)}
        return int(sum(sizes[v] for v in self.width_groups[dim]))

    @property
    def vocabs(self) -> Tuple[Tuple[str, int], ...]:
        """Unique PRIMARY-width (vocab_name, vocab_size) pairs in
        table-row order (explicit ``vocab_layout`` order when set, else
        spec order)."""
        d0 = self.embed_dim
        seen = {}
        for s in list(self.sparse) + list(self.seq):
            if s.dim == d0 and s.vocab not in seen:
                seen[s.vocab] = s.vocab_size
        if self.vocab_layout is not None:
            return tuple((n, seen[n])
                         for n, _ in sorted(self.vocab_layout,
                                            key=lambda t: t[1]))
        return tuple(seen.items())

    @property
    def total_vocab(self) -> int:
        """Fused-table rows, including any layout padding gaps."""
        if self.vocab_layout is not None:
            sizes = dict(self.vocabs)
            t = int(max(off + sizes[n] for n, off in self.vocab_layout))
        else:
            t = int(sum(v for _, v in self.vocabs))
        return max(t, self.min_table_rows or 0)

    @property
    def vocab_offsets(self) -> Mapping[str, int]:
        """Row offset of each vocab inside the fused embedding table."""
        if self.vocab_layout is not None:
            return dict(self.vocab_layout)
        out, off = {}, 0
        for name, size in self.vocabs:
            out[name] = off
            off += size
        return out

    @property
    def fingerprint(self) -> str:
        """Stable layout identity: hash of specs + realized row layout.
        Stamped into checkpoints so a restore into a differently-planned
        FeatureSet fails loudly instead of silently permuting vocab rows."""
        import hashlib

        offs = self.vocab_offsets
        desc = ";".join(
            [f"d:{s.name}" for s in self.dense]
            + [f"s:{s.name}:{s.vocab}:{s.vocab_size}:{s.dim}"
               for s in self.sparse]
            + [f"q:{s.name}:{s.vocab}:{s.vocab_size}:{s.max_len}:{s.dim}"
               for s in self.seq]
            + [f"o:{n}:{offs[n]}" for n, _ in self.vocabs]
            + [f"t:{self.total_vocab}"])
        return hashlib.sha256(desc.encode()).hexdigest()[:16]

    def sparse_offsets(self) -> np.ndarray:
        """(n_sparse,) int32 — offset to add to each sparse column's ids
        in the PRIMARY fused-table row space. Only meaningful when every
        sparse field is primary-width (raises otherwise — mixed-width
        lookups route per width group inside FusedEmbedding)."""
        d0 = self.embed_dim
        if any(s.dim != d0 for s in self.sparse):
            raise ValueError(
                "sparse_offsets() is the single-fused-table fast path; "
                "this FeatureSet has narrow-width sparse fields — use "
                "FusedEmbedding's per-group routing")
        offs = self.vocab_offsets
        return np.asarray([offs[s.vocab] for s in self.sparse], dtype=np.int32)

    def sparse_groups(self) -> Tuple[Tuple[int, int, Tuple[int, ...]], ...]:
        """Static grouping of PRIMARY-width sparse columns by vocab row
        range, for the grouped (overlapped) gather/scatter path: tuple of
        ``(row_lo, row_hi, (sparse column indices…))`` sorted by row_lo.
        XLA overlaps independent per-group gathers/scatters where it
        serializes one fused lookup (~6× on v5e at Criteo shapes, PERF.md)."""
        d0 = self.embed_dim
        offs = self.vocab_offsets
        sizes = dict(self.vocabs)
        by_vocab: dict = {}
        for i, s in enumerate(self.sparse):
            if s.dim == d0:
                by_vocab.setdefault(s.vocab, []).append(i)
        groups = [(offs[v], offs[v] + sizes[v], tuple(cols))
                  for v, cols in by_vocab.items()]
        return tuple(sorted(groups))

    def seq_offset(self, name: str) -> int:
        spec = self.seq_spec(name)
        if spec.dim != self.embed_dim:
            raise ValueError(
                f"seq field {name!r} is narrow-width (dim {spec.dim}); its "
                "rows live in the width-group sub-table — use "
                "aux_vocab_offsets(dim) / FusedEmbedding.seq")
        return int(self.vocab_offsets[spec.vocab])

    def sparse_index(self, name: str) -> int:
        for i, s in enumerate(self.sparse):
            if s.name == name:
                return i
        raise KeyError(name)

    def seq_spec(self, name: str) -> SeqSpec:
        for s in self.seq:
            if s.name == name:
                return s
        raise KeyError(name)

    def replace(self, **kw) -> "FeatureSet":
        return dataclasses.replace(self, **kw)


def criteo_feature_set(
    vocab_sizes: Sequence[int],
    n_dense: int = 13,
    embed_dim: int = 8,
) -> FeatureSet:
    """Criteo-format schema: 13 dense + 26 sparse (reference un_seq.py:39-40)."""
    dense = tuple(DenseSpec(f"I{i + 1}") for i in range(n_dense))
    sparse = tuple(
        SparseSpec(f"C{i + 1}", vocab_size=int(v), dim=embed_dim)
        for i, v in enumerate(vocab_sizes)
    )
    return FeatureSet(dense=dense, sparse=sparse)
