"""The paper's re-partition operator R_{x->y} on ``torch.distributed``.

Port of ``repro.core.repartition``. DistDL's ``repartition`` moves the
sharded dimension of a tensor from dim ``src`` to dim ``dst``:

  local X: [..., n_src/P (dim src), ..., n_dst (dim dst), ...]
  after  : [..., n_src   (dim src), ..., n_dst/P (dim dst), ...]

landing every element where ``jax.lax.all_to_all(split_axis=dst,
concat_axis=src, tiled=True)`` lands it. ``dist.all_to_all_single`` splits
along dim 0 only, so ``dst`` moves to the front and splits into P chunks,
chunk j going to rank j; the P chunks received are then laid along ``src``
in rank order. Complex tensors travel as their ``torch.view_as_real`` view.

The adjoint (conjugate transpose) of R_{src->dst} is R_{dst->src}: the
all-to-all is a permutation of elements across ranks, so its transpose is
its inverse. ``repartition`` is an autograd Function whose backward is
that reverse move, so every rank must run its backward in the same order,
as it runs its forward.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.collectives import counted


def _all_to_all(x: torch.Tensor, src: int, dst: int, group) -> torch.Tensor:
    p = dist.get_world_size(group)
    if x.shape[dst] % p:
        raise ValueError(f"dim {dst} (size {x.shape[dst]}) not divisible by {p} ranks")
    real = torch.view_as_real(x) if x.is_complex() else x
    send = real.movedim(dst, 0).contiguous()
    recv = torch.empty_like(send)
    with counted("all-to-all", recv, group):
        dist.all_to_all_single(recv, send, group=group)
    # recv: [P (source rank), n_dst/P, *rest], src at index s of rest
    s = src if src < dst else src - 1
    recv = recv.view((p, send.shape[0] // p) + tuple(send.shape[1:]))
    out = recv.movedim(0, s + 1).flatten(s + 1, s + 2).movedim(0, dst)
    return torch.view_as_complex(out.contiguous()) if x.is_complex() else out


class _Repartition(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, dst, group):
        ctx.move = (src, dst, group)
        return _all_to_all(x, src, dst, group)

    @staticmethod
    def backward(ctx, g):
        src, dst, group = ctx.move
        return _all_to_all(g, dst, src, group), None, None, None


def repartition(x: torch.Tensor, src: int, dst: int, group) -> torch.Tensor:
    """Move the sharded dim from ``src`` to ``dst`` over ``group``.

    ``x`` is the *local* shard: dim ``src`` holds the local chunk (global
    size / P) and dim ``dst`` is fully local. After the call, dim ``src`` is
    global and dim ``dst`` holds the local chunk. Differentiable.
    """
    if src == dst:
        raise ValueError("src and dst dims must differ")
    src, dst = src % x.ndim, dst % x.ndim
    if torch.is_grad_enabled() and x.requires_grad:
        return _Repartition.apply(x, src, dst, group)
    return _all_to_all(x, src, dst, group)


def repartition_t(x: torch.Tensor, src: int, dst: int, group) -> torch.Tensor:
    """Adjoint of ``repartition(., src, dst)`` = ``repartition(., dst, src)``."""
    return repartition(x, dst, src, group)


def apply_chunked(fn, x: torch.Tensor, chunks: int, dim: int) -> torch.Tensor:
    """``fn`` on ``chunks`` slices of ``x`` along ``dim``, concatenated back.

    Equal to ``fn(x)`` where ``fn`` treats ``dim`` as a batch dim. ``chunks``
    is clamped to the ``dim`` extent; chunk sizes may be uneven.
    """
    n = min(int(chunks), x.shape[dim])
    if n <= 1:
        return fn(x)
    c = x.shape[dim]
    bounds = [round(i * c / n) for i in range(n + 1)]
    return torch.cat([fn(x.narrow(dim, lo, hi - lo)) for lo, hi in zip(bounds, bounds[1:])],
                     dim=dim)


def repartition_chunked(
    x: torch.Tensor, src: int, dst: int, group, *, chunks: int = 2, chunk_dim: int = 1
) -> torch.Tensor:
    """``repartition`` issued as one all-to-all per slice of ``chunk_dim``
    (default the channel dim of the [b, c, x, y, z, t] layout), the slices
    concatenated back (``apply_chunked``).

    Bit-identical to the blocking call: the all-to-all is a pure element
    permutation that never mixes values across ``chunk_dim``.
    """
    if chunk_dim in (src, dst):
        raise ValueError(f"chunk_dim {chunk_dim} must differ from src={src}/dst={dst}")
    return apply_chunked(lambda t: repartition(t, src, dst, group), x, chunks, chunk_dim)


Move = Tuple[int, int, object]  # (src_dim, dst_dim, process group)


def repartition_multi(x: torch.Tensor, moves: Sequence[Move]) -> torch.Tensor:
    """Apply a sequence of per-group moves back to back; each (src, dst,
    group) is an independent all-to-all over that group."""
    for src, dst, group in moves:
        x = repartition(x, src, dst, group)
    return x


def repartition_multi_t(x: torch.Tensor, moves: Sequence[Move]) -> torch.Tensor:
    """Adjoint of ``repartition_multi``: reversed moves, each transposed."""
    for src, dst, group in reversed(moves):
        x = repartition(x, dst, src, group)
    return x
