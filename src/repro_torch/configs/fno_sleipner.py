"""The paper's Sleipner CO2-flow FNO (§V-B, CCS benchmark).

Paper grid 262x118x64 x 86 time steps padded to 256x128x64x88 (the original
2.1M-cell simulation grid, mesh-divisible). Inputs: binary injection-well
map (repeated along t); outputs: CO2 saturation history. Same ``CONFIG``
as ``repro.configs.fno_sleipner``, built from the port's ``FNOConfig``.
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

# What one 80 GB card serves at the paper's width: half the paper grid per
# spatial dim, same nt and modes (at the paper grid one float32 activation
# at batch 1 is 29.5 GB, and a block needs several), in batch buckets of up
# to ONE_CARD_SLOTS scenarios. chip_smoke.py and launch/profile_forward.py
# both serve this shape.
ONE_CARD_GRID = (128, 64, 32, 88)
ONE_CARD_SLOTS = 2

SHAPES = (
    ("train_b32", 32, "train"),
    ("infer_b32", 32, "infer"),
)
