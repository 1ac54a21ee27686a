"""Sleipner CO2-flow FNO on a 2-D pencil-decomposed ("mx", "my") layout.

Same physics/grid as ``fno_sleipner`` (256x128x64 x 88), but the solution
tensor is sharded along BOTH x and y. The 1-D Alg. 2 decomposition caps
model parallelism at min(nx, 2*my) = 32 ranks for this grid; the pencil
constraints (Px | nx, Px | 2my, Py | ny, Py | 2mz) allow Px*Py up to
32 * 16 = 512 model shards. Same ``CONFIG``, ``MODEL_AXES``,
``PENCIL_SHAPE`` and ``SHAPES`` as ``repro.configs.fno_sleipner_2d``,
built from the port's ``FNOConfig``; ``MODEL_AXES`` name the groups of
``launch.mesh.build_fno_groups``'s pencil pair.
"""
from repro_torch.core.fno import FNOConfig

CONFIG = FNOConfig(
    grid=(256, 128, 64, 88),
    modes=(24, 16, 8, 10),
    width=40,
    in_channels=1,
    out_channels=1,
    n_blocks=4,
    decoder_dim=128,
)

# Model-parallel group names of the pencil pair (``core.fno.group_names``).
MODEL_AXES = ("mx", "my")

# Production pencil shape: 8 x-shards x 4 y-shards = 32-way model
# parallelism with headroom to 512 (vs the hard 32 cap of the 1-D path).
PENCIL_SHAPE = (8, 4)

SHAPES = (
    ("train_b32", 32, "train"),
    ("infer_b32", 32, "infer"),
)
