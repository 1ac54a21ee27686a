"""Parallelism policy of the LM path: its serial half.

Port of ``repro.models.policy`` (``policy.py:20-98``) for one device, with
the fields that act there: ``remat`` checkpoints each layer of the
training forward (each superblock of the hybrid family) and
``remat_policy`` picks what the recompute keeps (None: nothing, the whole
layer runs again; ``"dots"``: the matrix products' outputs, the
reference's ``dots_saveable``). ``use_pallas`` is recorded as given, as
the FNO trainer records ``--use-pallas``: the port picks its kernels by
where the tensors lie. ``kv_quant`` is recorded too: only the split caches
of a distributed policy read it. ``shard``/``shard_act`` are the identity
without a mesh, as the reference's are; a policy with a mesh (the
production mesh's TP/DP/EP/SP layout, Ulysses, the MoE all-to-all) is the
distributed slice and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import NOT_PORTED

REMAT_POLICIES = (None, "dots")


@dataclasses.dataclass(frozen=True)
class ParallelPolicy:
    mesh: Optional[object] = None
    remat: bool = True
    remat_policy: Optional[str] = None
    use_pallas: bool = False
    kv_quant: bool = False

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(f"a ParallelPolicy over a mesh: {NOT_PORTED}")
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} is not one of {REMAT_POLICIES}")

    def shard(self, x, *spec):
        """The identity: there is no mesh to constrain ``x`` to."""
        return x

    def shard_act(self, x, seq_dim_shardable: bool = True):
        return x


LOCAL = ParallelPolicy()
