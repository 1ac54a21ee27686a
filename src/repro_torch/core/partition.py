"""Cartesian partition descriptors over ``torch.distributed`` groups.

Port of ``repro.core.partition``. The paper's model parallelism shards the
solution tensor X[b, c, x, y, z, t] over Cartesian partitions ("the input
tensor is distributed across the first spatial dimension x"). Here a
partition maps each tensor dim to the NAME of a process group (or None for
a replicated dim); a mapping of names to groups, which every rank builds
the same way (``launch.mesh.build_fno_groups``), gives each name its group.

The reference's ``spec``/``sharding`` (a PartitionSpec for ``shard_map``)
have no counterpart: a rank holds its local slice as a plain tensor.
``shard`` takes that slice from a global tensor and ``gather`` rebuilds
the global tensor from the slices.

One group per dim: a dim sharded by several groups is the 2-D pencil
decomposition, ROADMAP Queue 1 item 2b, not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the one refusal of every 2-D pencil request, here and in core/fno.py and launch/mesh.py
PENCILS = "the 2-D pencil decomposition is not ported yet (ROADMAP Queue 1 item 2b)"


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


@dataclasses.dataclass(frozen=True)
class CartPartition:
    """Maps tensor dimensions to process-group names.

    ``dims[i]`` is the name of the group sharding tensor dim i, or None for
    a replicated dim.
    """

    dims: Tuple[Optional[str], ...]

    def __post_init__(self):
        for i, name in enumerate(self.dims):
            if name is not None and not isinstance(name, str):
                raise ValueError(f"dim {i} sharded by {name!r}: {PENCILS}")

    def sharded_dims(self) -> Tuple[int, ...]:
        return tuple(i for i, a in enumerate(self.dims) if a is not None)

    def axis_of(self, dim: int) -> Optional[str]:
        return self.dims[dim]

    def with_moved(self, src_dim: int, dst_dim: int, axis: Optional[str] = None) -> "CartPartition":
        """Partition after repartitioning src_dim -> dst_dim (R_{x->y}).

        ``axis``, when given, must be the group sharding ``src_dim``. A
        ``dst_dim`` that is already sharded would then be sharded by two
        groups, which is the 2-D pencil decomposition and raises.
        """
        src_axis = self.dims[src_dim]
        if src_axis is None:
            raise ValueError(f"dim {src_dim} is not sharded; cannot repartition")
        if axis is not None and axis != src_axis:
            raise ValueError(f"dim {src_dim} not sharded by axis {axis!r}")
        if self.dims[dst_dim] is not None:
            raise ValueError(
                f"dim {dst_dim} already sharded by {self.dims[dst_dim]!r}; {PENCILS}"
            )
        new = list(self.dims)
        new[src_dim], new[dst_dim] = None, src_axis
        return CartPartition(tuple(new))

    def validate(self, shape: Sequence[int], groups: Mapping[str, object]) -> None:
        """Check every sharded dim is divisible by its group's size."""
        for i, name in enumerate(self.dims):
            if name is None:
                continue
            size = dist.get_world_size(groups[name])
            if shape[i] % size != 0:
                raise ValueError(
                    f"tensor dim {i} (size {shape[i]}) not divisible by group "
                    f"{name!r} (size {size})"
                )


def shard(x: torch.Tensor, part: CartPartition, groups: Mapping[str, object]) -> torch.Tensor:
    """This rank's local slice of the global tensor ``x`` (a contiguous copy)."""
    part.validate(x.shape, groups)
    for i in part.sharded_dims():
        x = local_slice(x, i, groups[part.dims[i]])
    return x.contiguous()


def gather(x: torch.Tensor, part: CartPartition, groups: Mapping[str, object]) -> torch.Tensor:
    """Inverse of ``shard``: the global tensor from every rank's slice (a
    collective: every rank of each group calls it)."""
    for i in part.sharded_dims():
        x = gather_dim(x, i, groups[part.dims[i]])
    return x
