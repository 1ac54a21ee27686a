"""Cartesian partition descriptors over ``torch.distributed`` groups.

Port of ``repro.core.partition``. The paper's model parallelism shards the
solution tensor X[b, c, x, y, z, t] over Cartesian partitions ("the input
tensor is distributed across the first spatial dimension x"). Here a
partition maps each tensor dim to the NAME of a process group, to a tuple
of names (a dim split by several groups, as the 2-D pencil decomposition's
repartitions leave it) or to None for a replicated dim; a mapping of names
to groups, which every rank builds the same way
(``launch.mesh.build_fno_groups``), gives each name its group.

The reference's ``spec``/``sharding`` (a PartitionSpec for ``shard_map``)
have no counterpart: a rank holds its local slice as a plain tensor.
``shard`` takes that slice from a global tensor and ``gather`` rebuilds
the global tensor from the slices. A dim split by the groups (g1, g2) is
laid out as JAX lays out ``P(("g1", "g2"))``: g1 takes the coarse split,
g2 splits each of its pieces again, so the rank at (i, j) holds piece
i * |g2| + j.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisName = Union[str, Tuple[str, ...]]


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in group-rank order
    (``dist.all_gather_into_tensor``, which gathers along dim 0). Complex
    tensors travel as their real view."""
    p = dist.get_world_size(group)
    real = torch.view_as_real(x) if x.is_complex() else x
    send = real.movedim(dim, 0).contiguous()
    recv = send.new_empty((p * send.shape[0],) + tuple(send.shape[1:]))
    dist.all_gather_into_tensor(recv, send, group=group)
    out = recv.movedim(0, dim)
    return torch.view_as_complex(out.contiguous()) if x.is_complex() else out


def local_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal share of ``x`` along ``dim`` (a view)."""
    p, r = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim]
    if n % p:
        raise ValueError(f"dim {dim} (size {n}) not divisible by {p} ranks")
    return x.narrow(dim, r * (n // p), n // p)


def _names(axes: Optional[AxisName]) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _pack(names: Tuple[str, ...]) -> Optional[AxisName]:
    if not names:
        return None
    return names[0] if len(names) == 1 else names


@dataclasses.dataclass(frozen=True)
class CartPartition:
    """Maps tensor dimensions to process-group names.

    ``dims[i]`` is the name (or tuple of names) of the group(s) sharding
    tensor dim i, or None for a replicated dim.
    """

    dims: Tuple[Optional[AxisName], ...]

    def sharded_dims(self) -> Tuple[int, ...]:
        return tuple(i for i, a in enumerate(self.dims) if a is not None)

    def axis_of(self, dim: int) -> Optional[AxisName]:
        return self.dims[dim]

    def with_moved(self, src_dim: int, dst_dim: int, axis: Optional[str] = None) -> "CartPartition":
        """Partition after repartitioning src_dim -> dst_dim (R_{x->y}).

        ``axis`` names the group that moves when ``src_dim`` is sharded by
        several; omitted, the dim must be sharded by exactly one. If
        ``dst_dim`` is already sharded, the moved group is appended to its
        tuple (innermost), so chained per-group moves compose.
        """
        src = _names(self.dims[src_dim])
        if not src:
            raise ValueError(f"dim {src_dim} is not sharded; cannot repartition")
        if axis is None:
            if len(src) != 1:
                raise ValueError(f"dim {src_dim} sharded by multiple axes {src}; "
                                 "name the axis to move")
            axis = src[0]
        if axis not in src:
            raise ValueError(f"dim {src_dim} not sharded by axis {axis!r}")
        dst = _names(self.dims[dst_dim])
        if axis in dst:
            raise ValueError(f"dim {dst_dim} already sharded by {axis!r}")
        new = list(self.dims)
        new[src_dim] = _pack(tuple(a for a in src if a != axis))
        new[dst_dim] = _pack(dst + (axis,))
        return CartPartition(tuple(new))

    def validate(self, shape: Sequence[int], groups: Mapping[str, object]) -> None:
        """Check every sharded dim is divisible by its groups' sizes' product."""
        for i, axes in enumerate(self.dims):
            names = _names(axes)
            size = 1
            for name in names:
                size *= dist.get_world_size(groups[name])
            if shape[i] % size != 0:
                raise ValueError(
                    f"tensor dim {i} (size {shape[i]}) not divisible by groups "
                    f"{names} (product {size})"
                )

    def index(self, shape: Sequence[int], groups: Mapping[str, object]) -> Tuple[slice, ...]:
        """This rank's slice of a global tensor of ``shape`` (no collective)."""
        self.validate(shape, groups)
        used = {name for axes in self.dims for name in _names(axes)}
        return self.index_at(shape, coords({name: groups[name] for name in used}))

    def index_at(self, shape: Sequence[int], at: Mapping[str, Tuple[int, int]]) -> Tuple[slice, ...]:
        """The slice of a global tensor of ``shape`` held by the rank whose
        ``coords`` are ``at``: what one rank computes for another's shard."""
        out = []
        for n, axes in zip(shape, self.dims):
            piece, total = 0, 1
            for name in _names(axes):
                rank, size = at[name]
                piece, total = piece * size + rank, total * size
            if n % total:
                raise ValueError(f"size {n} not divisible by groups {_names(axes)} "
                                 f"(product {total})")
            out.append(slice(piece * (n // total), (piece + 1) * (n // total)))
        return tuple(out)

    def local_shape(self, shape: Sequence[int], groups: Mapping[str, object]) -> tuple:
        """The shape of this rank's shard of a global tensor of ``shape``."""
        return tuple(s.stop - s.start for s in self.index(shape, groups))

    def global_shape(self, local_shape: Sequence[int], groups: Mapping[str, object]) -> tuple:
        """The global shape whose shards are ``local_shape``."""
        out = []
        for n, axes in zip(local_shape, self.dims):
            for name in _names(axes):
                n *= dist.get_world_size(groups[name])
            out.append(n)
        return tuple(out)


def coords(groups: Mapping[str, object]) -> dict:
    """This rank's (rank, size) in each named group."""
    return {name: (dist.get_rank(g), dist.get_world_size(g)) for name, g in groups.items()}


def shard(x: torch.Tensor, part: CartPartition, groups: Mapping[str, object]) -> torch.Tensor:
    """This rank's local slice of the global tensor ``x`` (a contiguous copy)."""
    return x[part.index(x.shape, groups)].contiguous()


def gather(x: torch.Tensor, part: CartPartition, groups: Mapping[str, object]) -> torch.Tensor:
    """Inverse of ``shard``: the global tensor from every rank's slice (a
    collective: every rank of each group calls it). A dim split by several
    groups is gathered over the innermost first."""
    for i in part.sharded_dims():
        for name in reversed(_names(part.dims[i])):
            x = gather_dim(x, i, groups[name])
    return x


def shard_tree(tree: dict, parts: dict, groups: Mapping[str, object]) -> dict:
    """``shard`` of every leaf of a nested dict under the matching leaf of
    ``parts`` (a leaf whose partition is None stays as it is)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, parts[k], groups) for k, v in tree.items()}
    return tree if parts is None else shard(tree, parts, groups)


def gather_tree(tree: dict, parts: dict, groups: Mapping[str, object]) -> dict:
    """Inverse of ``shard_tree`` (a collective over every group the parts
    name): each leaf's global tensor."""
    if isinstance(tree, dict):
        return {k: gather_tree(v, parts[k], groups) for k, v in tree.items()}
    return tree if parts is None else gather(tree, parts, groups)
