"""SIM's general search unit with the long key axis sharded over ``model``.

Counterpart of ``ml_function_tpu/parallel/longseq.py``. Each rank at
``(i, j)`` holds the rows of data shard i and handles model slice j of the
long stream's columns, a ``(B_loc, L/M)`` block:

1. it fetches the rows of its block's ids through the owner-routed exchange
   (``embedding.a2a_fetch``: the a2a lookup without its closing gather), so
   no rank holds the ``(B_loc, L, D)`` stream;
2. it scores them against the candidate (replicated over the model group),
   pad positions at ``-inf``, and keeps its block's top ``min(k, L/M)``,
   their positions made global (``j·L/M + i``);
3. one ``all_gather`` over the model group of the blocks' winners (scores,
   positions, masks) and a merge by the key (−score, position): the choice
   and order of ``lax.top_k`` over the whole axis, so the sharded search
   selects what the unsharded one does.

The search returns integers and carries no gradient, as the reference's
stops it: the caller (SIM) looks up the selected ids again, differentiably.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..features.schema import FeatureSet
from ..models.longseq import top_k_indices
from . import comm
from .embedding import a2a_fetch
from .mesh import Mesh


@torch.no_grad()
def seq_sharded_soft_search(mesh: Mesh, fs: FeatureSet, long_fields: Sequence[str],
                            top_k: int, table: torch.Tensor,
                            seq_ids: Dict[str, torch.Tensor], cand: torch.Tensor,
                            capacity: Optional[int] = None,
                            compress: Optional[str] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft search over the long fields with the stream's columns sharded
    over ``model``. ``table``: this rank's row block of the fused table;
    ``seq_ids``: this rank's batch rows' seq dict (each long field (B_loc, L)
    ids, whole); ``cand``: (B_loc, Σ dims) candidate rows of the long
    fields' vocabs. Returns ``(top_idx (B_loc, k) positions into the long
    axis, red_mask (B_loc, k))``, the same on every rank of the model group.
    ``L`` must divide by the model axis, and every long field must have the
    same ``max_len``."""
    m, j = mesh.model, mesh.model_index
    d = fs.embed_dim
    L = fs.seq_spec(long_fields[0]).max_len
    for n in long_fields:
        if fs.seq_spec(n).max_len != L:
            raise ValueError("seq-sharded GSU needs equal max_len across "
                             f"long fields (got {n}: "
                             f"{fs.seq_spec(n).max_len} vs {L})")
    if L % m:
        raise ValueError(f"long length {L} must divide the model axis {m} "
                         "for sequence sharding")
    lb = L // m
    k = min(top_k, L)
    k_loc = min(k, lb)
    b_loc = cand.shape[0]
    s = b_loc * lb
    # a bucket never holds more unique ids than its owner has rows: the cap
    # stays lossless and the exchange buffers are bounded by the vocab
    cap = min(capacity or s, table.shape[0])
    rows_f, masks = [], None
    for n in long_fields:
        blk = seq_ids[n][:, j * lb:(j + 1) * lb]
        gids = (blk.long() + fs.seq_offset(n)).reshape(-1)
        rows = a2a_fetch(table, gids, j, m, mesh.model_group, cap, compress)
        mask = blk != 0
        rows_f.append(rows.reshape(b_loc, lb, d) * mask[..., None])   # pads zeroed
        masks = mask if masks is None else masks | mask
    scores = torch.einsum("bld,bd->bl", torch.cat(rows_f, dim=-1), cand)
    scores = torch.where(masks, scores, -torch.inf)

    loc_i = top_k_indices(scores, k_loc)
    loc_s = torch.gather(scores, 1, loc_i)
    gidx = j * lb + loc_i
    sel_mask = torch.gather(masks, 1, loc_i)
    group = mesh.model_group
    cat_s = comm.all_gather_tensor(loc_s, group, dim=1)
    # positions ship as int32, as the reference's (L is far below 2^31)
    cat_i = comm.all_gather_tensor(gidx.int(), group, dim=1).long()
    cat_m = comm.all_gather_tensor(sel_mask, group, dim=1)
    # the key (−score, position): sort by position, then stably by score
    by_pos = torch.argsort(cat_i, dim=1, stable=True)
    sel = torch.gather(by_pos, 1, top_k_indices(torch.gather(cat_s, 1, by_pos), k))
    return torch.gather(cat_i, 1, sel), torch.gather(cat_m, 1, sel)


def seq_shard_wire_bytes(batch_per_dev: int, L: int, m: int, d: int, k: int,
                         nf: int = 1, bytes_per: int = 4) -> Dict[str, float]:
    """Per-rank wire bytes of one sequence-sharded search against the
    replicated-key alternative (the reference's formula)."""
    s = batch_per_dev * (L // m)
    a2a_ids = s * 4 * 2                      # request + (int32) echo ids
    a2a_rows = s * d * bytes_per             # worst-case row payload back
    merge = batch_per_dev * min(k, L // m) * (m - 1) * (d + 3) * bytes_per
    sharded = nf * (a2a_ids + a2a_rows) + merge
    replicated = nf * batch_per_dev * L * d * bytes_per  # full activation
    return {"sharded_bytes": float(sharded),
            "replicated_bytes": float(replicated),
            "ratio": float(replicated / max(sharded, 1.0))}
