"""Collectives that carry a gradient, for the tensor-parallel LM layers.

``torch.distributed``'s collectives have no backward. The distributed LM
(``models/policy.py`` over process groups) is a Megatron-style
translation of what GSPMD does for the reference, and needs these pairs,
each an ``autograd.Function`` (forward / backward):

=========================  ==================  ====================
``copy_to(x, g)``          identity            all-reduce
``reduce_from(x, g)``      all-reduce          identity
``all_gather(x, d, g)``    all-gather on d     reduce-scatter on d
``reduce_scatter(x,d,g)``  reduce-scatter on d all-gather on d
``gather_from(x, d, g)``   all-gather on d     this rank's slice
``scatter_to(x, d, g)``    this rank's slice   all-gather on d
``sum_copies(x, g)``       all-reduce          all-reduce
=========================  ==================  ====================

Which one a layer takes follows from how the loss lies over the groups.
The ranks of a model group hold one loss between them: a tensor they all
hold alike carries its whole gradient on every rank. So a collective
whose output the ranks use alike (``gather_from``, ``reduce_from``) hands
back the plain cotangent, and one whose ranks each use a different part
of its output (``copy_to`` before a column-parallel product,
``all_gather`` before each rank takes its heads) sums the ranks'
cotangents. The ranks of a data group each hold their own loss term
(the mean over their rows), which the trainer averages: a sum over the
data group that every term depends on (the MoE's routing statistics)
sums its cotangents too (``sum_copies``).

A group of one rank makes each of these the identity. gloo has no
reduce-scatter, so one is an all-reduce and a slice. Within ``timed()``
each call waits for the device before and after and adds its wall time
to the block's count: the collectives' share of a step. The count also
keeps each call's kind ("all-reduce", "all-gather", "all-to-all"), the
bytes of its result and its group's size (``ops``), from which
``launch.comm_analysis`` models the bytes on the wire. ``counted`` does
the same for a collective issued elsewhere (``core.repartition``'s
all-to-all, the trainer's gradient all-reduce).
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

# the count of the innermost ``timed()`` block, or None outside one
_timed = None


@contextlib.contextmanager
def timed(sync: bool = True):
    """Within the block every collective of this process waits for the
    device before and after it and is counted: yields {"seconds",
    "calls", "ops"}, their wall time, their number and each one's (kind,
    result bytes, group size). With ``sync=False`` the calls are counted
    and recorded only (no wait, "seconds" stays 0)."""
    global _timed
    count, outer = {"seconds": 0.0, "calls": 0, "ops": [], "sync": sync}, _timed
    _timed = count
    try:
        yield count
    finally:
        _timed = outer


def size_of(group) -> int:
    return 1 if group is None else group.size()


class counted:
    """``with counted(kind, result, group):`` around one collective whose
    result is the tensor ``result`` over ``group`` (None: the world):
    within ``timed()`` it is timed between device syncs and recorded
    (kind, result bytes, group size)."""

    def __init__(self, kind: str, result, group):
        self.cuda, self.count = result.is_cuda, _timed
        if self.count is None:
            return
        g = dist.get_world_size() if group is None else group.size()  # None: the world
        self.op = (kind, result.numel() * result.element_size(), g)

    def __enter__(self):
        if self.count is not None and self.count["sync"]:
            if self.cuda:
                torch.cuda.synchronize()
            self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.count is not None:
            if self.count["sync"]:
                if self.cuda:
                    torch.cuda.synchronize()
                self.count["seconds"] += time.perf_counter() - self.t0
            self.count["calls"] += 1
            self.count["ops"].append(self.op)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    with counted("all-reduce", out, group):
        dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x, dim, group):
    p = size_of(group)
    send = x.movedim(dim, 0).contiguous()
    recv = send.new_empty((p * send.shape[0],) + tuple(send.shape[1:]))
    with counted("all-gather", recv, group):
        dist.all_gather_into_tensor(recv, send, group=group)
    return recv.movedim(0, dim).contiguous()


def _slice(x, dim, group):
    p, r = size_of(group), group.rank()
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"dim {dim} (size {n}) not divisible by {p} ranks")
    return x.narrow(dim, r * (n // p), n // p)


def _reduce_scatter(x, dim, group):
    return _slice(_all_reduce(x, group), dim, group).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumCopies(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.move = (dim, group, summed)
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        dim, group, summed = ctx.move
        return (_reduce_scatter(g, dim, group) if summed else
                _slice(g, dim, group).contiguous()), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, summed):
        ctx.move = (dim, group)
        return _reduce_scatter(x, dim, group) if summed else _slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group = ctx.move
        return _all_gather(g, dim, group), None, None, None


def _alone(group) -> bool:
    return size_of(group) == 1


def copy_to(x, group):
    """Identity; the backward sums the ranks' cotangents (a replicated
    tensor entering a region where each rank computes its own part)."""
    return x if _alone(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    """Sum over ``group``, which every rank then holds alike; the backward
    is the identity (a row-parallel product's partial sums)."""
    return x if _alone(group) else _ReduceFrom.apply(x, group)


def sum_copies(x, group):
    """Sum over ``group`` whose every rank's result feeds its own loss
    term: the backward sums the cotangents too."""
    return x if _alone(group) else _SumCopies.apply(x, group)


def all_gather(x, dim: int, group):
    """Concatenate the ranks' ``x`` along ``dim``, each rank then using its
    own part of the result: the backward reduce-scatters."""
    return x if _alone(group) else _AllGather.apply(x, dim % x.dim(), group, True)


def reduce_scatter(x, dim: int, group):
    """Sum over ``group`` and keep this rank's slice along ``dim``; the
    backward all-gathers."""
    return x if _alone(group) else _Scatter.apply(x, dim % x.dim(), group, True)


def gather_from(x, dim: int, group):
    """Concatenate the ranks' ``x`` along ``dim`` into a tensor every rank
    then uses alike: the backward keeps this rank's slice."""
    return x if _alone(group) else _AllGather.apply(x, dim % x.dim(), group, False)


def scatter_to(x, dim: int, group):
    """This rank's slice along ``dim`` of a tensor the ranks hold alike;
    the backward all-gathers."""
    return x if _alone(group) else _Scatter.apply(x, dim % x.dim(), group, False)


def all_reduce_max(x, group):
    """Elementwise max over ``group`` (no gradient: a softmax's shift)."""
    return x if _alone(group) else _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def all_reduce_sum(x, group):
    """Sum over ``group`` with no gradient (counts)."""
    return x if _alone(group) else _all_reduce(x.detach(), group)
