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

# What one 80 GB card trains at the paper's width: a quarter of the paper
# grid per x/y dim and half along z, same nt and modes (2*24 <= 64,
# 2*16 <= 32, 2*8 <= 32), batches of ONE_CARD_TRAIN_BATCH run as
# ONE_CARD_TRAIN_ACCUM micro-batches of one sample. The training state
# alone is 44 GB (w_spec 12.6 GB, its gradient 12.6, AdamW's mu 12.6 and
# nu 6.3); one float32 activation is 0.92 GB per sample at this grid, and
# with per-block remat a micro-batch of one keeps the rest of a step
# within the card. Grid 128x64x32 at batch 2 would need about 90 GB.
# chip_smoke.py and launch/profile_forward.py both train this shape.
ONE_CARD_TRAIN_GRID = (64, 32, 32, 88)
ONE_CARD_TRAIN_BATCH = 2
ONE_CARD_TRAIN_ACCUM = 2

SHAPES = (
    ("train_b32", 32, "train"),
    ("infer_b32", 32, "infer"),
)
