"""The paper's Navier-Stokes FNO (turbulent flow around a sphere, §V-A).

Paper grid 130x130x130x64 padded to 128^3 x 64 (mesh-divisible; the serial
forward supports arbitrary grids). ~20-25% of modes kept per dim (paper:
"we truncated around 80 percent of the frequencies in each dimension");
2*m_y must divide the 16-way model axis, hence m_y=16. Same ``CONFIG``
and ``SHAPES`` as ``repro.configs.fno_ns3d``, built from the port's
``FNOConfig``.
"""
from repro_torch.core.fno import FNOConfig

CONFIG = FNOConfig(
    grid=(128, 128, 128, 64),
    modes=(16, 16, 16, 8),
    width=40,
    in_channels=1,   # binary sphere map, repeated along t
    out_channels=1,  # vorticity
    n_blocks=4,
    decoder_dim=128,
)

# (name, global_batch, kind) — batches divide the 32-way (pod x data) axes
SHAPES = (
    ("train_b32", 32, "train"),
    ("infer_b32", 32, "infer"),
)
