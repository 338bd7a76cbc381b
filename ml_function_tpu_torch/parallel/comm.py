"""The collectives of the sharded paths, on a mesh group.

Each takes a group of ``mesh.py`` (None without a process group, where it
is the identity). The differentiable ones are ``torch.autograd.Function``s
whose backward is the transpose that ``shard_map`` gives the same
collective in the reference:

- ``all_reduce_sum``: forward a sum over the group, backward a sum of the
  cotangents over the group (every rank's loss reads the sum);
- ``all_gather_cat``: forward the group's pieces concatenated, backward the
  rank's own slice of the cotangent, summing nothing. Every rank of the
  group holds the same cotangent of the gathered tensor (the ranks compute
  the same thing from it), so a sum would count it once a rank;
- ``sum_grad``: forward the identity, backward a sum of the cotangents over
  the group: the input of a computation that each rank of the group runs on
  its own block (MMoE's experts), whose cotangent each rank holds only in
  part;
- ``replicated_sum``: forward a sum over the group, backward the identity:
  the sum is replicated, and every rank of the group holds the same
  cotangent of it (``psum``'s transpose under ``shard_map``'s replication
  check);
- ``mean_grad``: forward the identity, backward the cotangent over the
  group size: an output that each rank computes whole and ``shard_map``
  returns unchecked as replicated (its transpose splits the cotangent over
  the devices);
- ``ppermute``: group rank i sends to rank (i + shift) mod n; the backward
  is the reverse permute of the cotangent (``lax.ppermute``'s transpose).

``all_max`` (``pmax``) takes no gradient, as the reference stops it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# torch 2.13 names the gather into one tensor ``all_gather_single`` and
# deprecates ``all_gather_into_tensor`` (a FutureWarning each call); torch
# 2.11 has only the old name
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no gradient)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather_tensor(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order (no
    gradient)."""
    if group is None:
        return x
    n = group_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group=group)
    if dim == 0:
        return out
    return torch.cat(out.chunk(n, dim=0), dim=dim)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) → (n, ...): block ``p`` goes to group rank ``p``, and block
    ``p`` of the result came from group rank ``p`` (``all_to_all_single``
    with equal splits; its own transpose)."""
    if group is None:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over ``group`` (no gradient)."""
    out = x.detach().clone()
    if group is not None:
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = group_size(group)
    if n == 1 or shift % n == 0:
        return x.clone()
    r = group_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    # P2POp takes global ranks; NCCL and gloo both refuse a send to self,
    # which a shift of 0 mod n (handled above) would be
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def barrier(group=None) -> None:
    if dist.is_available() and dist.is_initialized():
        dist.barrier(group=group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over ``group``."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather_tensor(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), None, None


def all_gather_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Differentiable gather along ``dim``; the backward takes this rank's
    slice of the cotangent (see the module docstring)."""
    if group is None:
        return x
    return _AllGatherCat.apply(x, group, dim)



class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The identity, whose backward sums the cotangent over ``group``."""
    if group is None:
        return x
    return _SumGrad.apply(x, group)


class _ReplicatedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicated_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A sum over ``group`` whose backward is the identity (see the module
    docstring)."""
    if group is None:
        return x
    return _ReplicatedSum.apply(x, group)


class _MeanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def mean_grad(x: torch.Tensor, group) -> torch.Tensor:
    """The identity, whose backward divides the cotangent by the group's
    size."""
    n = group_size(group)
    return x if n == 1 else _MeanGrad.apply(x, n)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Differentiable cyclic shift over ``group``: group rank i's ``x`` lands
    on rank (i + shift) mod n. A group of one (or none) is a local copy."""
    if group_size(group) == 1:
        return x.clone()
    return _Ppermute.apply(x, group, shift)
