"""Parallelism policy: how an LM maps onto ranks.

Port of ``repro.models.policy`` (``policy.py:19-98``). Without a mesh the
policy is the serial one: ``remat`` checkpoints each layer of the training
forward (each superblock of the hybrid family), ``remat_policy`` picks
what the recompute keeps (None: nothing; ``"dots"``: the matrix products'
outputs, the reference's ``dots_saveable``), and ``shard``/``shard_act``
are the identity. ``use_pallas`` is recorded as given, as the FNO trainer
records ``--use-pallas``: the port picks its kernels by where the tensors
lie.

With a mesh, the reference's ``mesh`` (a ``jax.sharding.Mesh``) is a
mapping of names to ``torch.distributed`` process groups, ``{"data": g,
"model": g}``, as ``launch.mesh.build_lm_groups`` builds them; each rank
holds its own. ``shard`` cannot be a sharding constraint in torch: the
layers below (``models/attention.py``, ``models/moe.py``,
``models/layers.py``, ``models/transformer.py``) call the collectives
themselves, Megatron-style (``core/collectives.py``), and ``shard``'s rule
(an axis whose size does not divide the dim is dropped) decides where a
tensor stays whole: ``splits`` answers it. Under ``seq_shard`` the
residual stream between blocks holds this rank's slice of the sequence.
The port's meshes have two axes, ``"data"`` and ``"model"``.

Serving under a mesh keeps split KV caches (``models/attention.py``), with
the prefix int8 under ``kv_quant`` (MLA's latent prefix keeps the cache
dtype, as the reference's). The reference's ``moe_a2a`` has no
counterpart: the MoE takes its all-to-all wherever the reference's
condition allows it (``models/moe.py``). Nor has its ``unroll_decode``:
the port's decode step is already a Python loop over the layers, which
holds no layer's cache in a loop carry. What a model group cannot split
is refused by name where the model meets it
(``models.transformer.check_mesh_arch``).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

REMAT_POLICIES = (None, "dots")
DATA_AXIS, MODEL_AXIS = "data", "model"


@dataclasses.dataclass(frozen=True)
class ParallelPolicy:
    mesh: Optional[Mapping[str, object]] = None
    # Megatron-style sequence sharding of the residual stream over the
    # model group (an all-gather before each block, a reduce-scatter after)
    seq_shard: bool = False
    remat: bool = True
    remat_policy: Optional[str] = None
    use_pallas: bool = False
    # int8 KV-cache prefix with per-token, per-head bf16 scales (split
    # caches: every attention cache under a mesh without a window)
    kv_quant: bool = False

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r} is not one of {REMAT_POLICIES}")
        if self.mesh is None:
            return
        missing = [a for a in (DATA_AXIS, MODEL_AXIS) if a not in self.mesh]
        if missing:
            raise ValueError(f"the mesh {sorted(self.mesh)} has no group for axes {missing}")

    @property
    def distributed(self) -> bool:
        return self.mesh is not None

    @property
    def model_group(self):
        return None if self.mesh is None else self.mesh[MODEL_AXIS]

    @property
    def data_group(self):
        return None if self.mesh is None else self.mesh[DATA_AXIS]

    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh[MODEL_AXIS].size()

    def dp_size(self) -> int:
        return 1 if self.mesh is None else self.data_group.size()

    def splits(self, n: int) -> bool:
        """Whether the model axis shards a dim of size ``n``: there is more
        than one model rank and it divides ``n`` (``shard``'s rule)."""
        p = self.model_size()
        return p > 1 and n % p == 0

    def seq_sharded(self, s: int) -> bool:
        """Whether the residual stream of an ``s``-token sequence holds this
        rank's slice of it (``seq_shard``, and the model axis divides s)."""
        return self.seq_shard and self.splits(s)

    def data_rank(self) -> int:
        return 0 if self.mesh is None else self.data_group.rank()

    def model_rank(self) -> int:
        return 0 if self.mesh is None else self.model_group.rank()

    def model_only(self) -> "ParallelPolicy":
        """This policy with a data group of one rank (``ONE_RANK``): what
        one data rank's model group runs alone, such as a serving runner's
        prefill of a slot that its data rank holds."""
        if self.mesh is None:
            return self
        return dataclasses.replace(self, mesh={DATA_AXIS: ONE_RANK, MODEL_AXIS: self.model_group})

    def shard(self, x, *spec):
        """The identity: a rank holds its shard already, and the layers
        call the collectives that move it."""
        return x

    def shard_act(self, x, seq_dim_shardable: bool = True):
        return x


class _OneRank:
    """A group of one rank: every collective over it is the identity
    (``core/collectives.py``), so nothing is sent."""

    def size(self) -> int:
        return 1

    def rank(self) -> int:
        return 0


ONE_RANK = _OneRank()
LOCAL = ParallelPolicy()
