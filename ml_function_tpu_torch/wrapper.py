"""Feature-column wrapper aliases of the port (a copy of
``ml_function_tpu/wrapper.py``).

Parity with the reference's newer (unwired) API surface
``kon/wrapper/Feature_Columns.py:11-34``: ``NumsFea``/``CateFea``/
``BehaviorFea`` map onto the real schema dataclasses.
"""

from __future__ import annotations

from typing import Optional

from .features.schema import DenseSpec, SeqSpec, SparseSpec


def NumsFea(fea_name: str, **_ignored) -> DenseSpec:
    """Numeric feature (reference NumsFea, Feature_Columns.py:21)."""
    return DenseSpec(fea_name)


def CateFea(fea_name: str, word_size: int, cross_unit: int = 8,
            emb_reg: float = 1e-8, is_trainable: bool = True,
            **_ignored) -> SparseSpec:
    """Categorical feature (reference CateFea, Feature_Columns.py:26)."""
    return SparseSpec(fea_name, vocab_size=word_size, dim=cross_unit,
                      emb_l2=emb_reg, trainable=is_trainable)


def BehaviorFea(fea_name: str, word_size: int, input_length: int,
                cross_unit: int = 8, emb_reg: float = 1e-8,
                vocab_name: Optional[str] = None,
                **_ignored) -> SeqSpec:
    """Behavior-sequence feature (reference BehaviorFea,
    Feature_Columns.py:31)."""
    return SeqSpec(fea_name, vocab_size=word_size, max_len=input_length,
                   dim=cross_unit, emb_l2=emb_reg, vocab_name=vocab_name)
