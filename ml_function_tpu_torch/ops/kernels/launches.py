"""The kernels' launch counters, read and moved together.

Each wrapper adds one to its module's counter (``cin.cin_fwd_launches``
and the rest) where it launches its kernel, and the CIN, field-attention
and (AU)GRU wrappers also count by instance (``instance_launches``). A
CUDA graph launches what it captured without passing through the
wrappers, so the chained train step (``train/loop.py``) takes each
counter's change over its capture (``since``), takes it back, and adds it
again at every replay (``add``): the counts stay those of the kernels that
ran.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from . import cin, embedding_grad, field_attention, flash_attention, gru

COUNTERS = ((cin, "cin_fwd_launches"), (cin, "cin_bwd_launches"),
            (field_attention, "field_attn_fwd_launches"),
            (field_attention, "field_attn_bwd_launches"),
            (gru, "gru_fwd_launches"), (gru, "gru_bwd_launches"),
            (embedding_grad, "merge_scatter_launches"),
            (flash_attention, "flash_fwd_launches"),
            (flash_attention, "flash_bwd_dq_launches"),
            (flash_attention, "flash_bwd_dkv_launches"))
BY_INSTANCE = (cin, field_attention, gru)

# (module, attribute, instance name or None) → launches
Counts = Dict[Tuple[object, str, Optional[str]], int]


def snapshot() -> Counts:
    """Every counter now, the instance counts included."""
    out: Counts = {(mod, attr, None): getattr(mod, attr) for mod, attr in COUNTERS}
    for mod in BY_INSTANCE:
        for name, n in mod.instance_launches.items():
            out[(mod, "instance_launches", name)] = n
    return out


def since(before: Counts) -> Counts:
    """Each counter's change since ``before`` (those that moved)."""
    now = snapshot()
    return {key: n - before.get(key, 0) for key, n in now.items()
            if n != before.get(key, 0)}


def add(delta: Counts, times: int = 1) -> None:
    """Add ``times`` × ``delta`` to the counters (a negative ``times``
    takes it back)."""
    for (mod, attr, name), n in delta.items():
        if name is None:
            setattr(mod, attr, getattr(mod, attr) + times * n)
        else:
            counts = getattr(mod, attr)
            counts[name] = counts.get(name, 0) + times * n
            if not counts[name]:
                del counts[name]
