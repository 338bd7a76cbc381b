"""Pipeline parallelism: the GPipe microbatch schedule over the model group.

Counterpart of ``ml_function_tpu/parallel/pipeline.py``. The rank at model
coordinate s runs stage s. The schedule is the reference's, tick for tick:
``S + M − 1`` ticks; at tick t stage 0 takes microbatch ``clip(t, 0, M−1)``
and every other stage takes what its predecessor handed on at t − 1; every
stage computes at every tick and hands its output to the next with
``ppermute``; the last stage's outputs at ticks ``S−1 … S+M−2`` are the
result, kept on that stage and summed over the group, so every rank holds
them.

The backward is the reference's transpose of that program. The stages'
choices between their inputs are ``torch.where``s, as the reference's are,
so that every rank takes part in every reverse permute. The sum over the
group takes the identity (``comm.replicated_sum``); the input, replicated
over the group, has its gradient summed over it (``comm.sum_grad``, stage
0's alone is not zero); and the stacked stage parameters, which every rank
holds whole while it reads only its own stage's slice, have theirs summed
too (``comm.sum_grad``), so that every rank ends with every stage's
gradient, as the reference's sharded stack has.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from . import comm
from .mesh import DATA_AXIS, MODEL_AXIS, Mesh


def _tree_map(fn, *trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] → one tree with a leading stage axis
    (differentiable: ``torch.stack`` of the leaves)."""
    return _tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def pipeline_spec_tree(stacked_params, axis_name: str = MODEL_AXIS) -> Dict[str, Any]:
    """The sharding of each stacked leaf, as the reference's PartitionSpec
    tree: the leading (stage) axis over ``axis_name``."""
    return _tree_map(lambda x: (axis_name,) + (None,) * (x.dim() - 1), stacked_params)


def make_pipeline(mesh: Mesh, stage_fn: Callable, n_microbatches: int,
                  axis_name: str = MODEL_AXIS, data_axis: str = DATA_AXIS) -> Callable:
    """``call(stacked_params, x) -> y``: ``stage_fn`` as an S-stage pipeline
    over the model group (S its size), one stage a rank, composed with the
    batch split over the data group. ``stage_fn(stage_params, x)`` maps
    (mb, d) to (mb, d); ``stacked_params`` is a tree whose leaves have the
    leading dim S; ``x`` is this rank's (B_loc, d) rows."""
    if (axis_name, data_axis) != (MODEL_AXIS, DATA_AXIS):
        raise ValueError(f"the port's mesh pipelines over {MODEL_AXIS!r} and splits "
                         f"the batch over {DATA_AXIS!r}")
    n_stages, s_idx, group = mesh.model, mesh.model_index, mesh.model_group
    m = n_microbatches

    def call(stacked_params, x):
        b, d = x.shape
        if b % m:
            raise ValueError(f"batch {b * mesh.data} must divide into {mesh.data} data "
                             f"shards × {m} microbatches")
        stacked = _tree_map(lambda a: comm.sum_grad(a, group), stacked_params)
        sparams = _tree_map(lambda a: a[s_idx], stacked)
        x_mb = comm.sum_grad(x, group).reshape(m, b // m, d)
        act = x.new_zeros((b // m, d))
        first = torch.tensor(s_idx == 0, device=x.device)
        last = torch.tensor(s_idx == n_stages - 1, device=x.device)
        outs = []
        for t in range(n_stages + m - 1):
            inp = torch.where(first, x_mb[min(t, m - 1)], act)
            out = stage_fn(sparams, inp)
            outs.append(out)
            if t < n_stages + m - 2:     # the last tick's hand-off feeds nothing
                act = comm.ppermute(out, group, 1)
        y = torch.stack(outs[n_stages - 1:])                    # (M, mb, d)
        y = torch.where(last, y, 0.0)
        return comm.replicated_sum(y, group).reshape(b, d)

    return call
