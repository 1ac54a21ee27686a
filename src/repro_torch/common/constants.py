"""Hardware constants of the port's target, one NVIDIA H100 SXM (80 GB HBM3).

The counterpart of ``repro.common.constants``, with the H100's figures in
place of the TPU's (NVIDIA's H100 SXM data sheet, dense rates): the
roofline bounds of ``chip_smoke.py`` and the ``launch/ab_*`` scripts and
the dry-run's floor times (``launch/dryrun.py``) are computed against
them. ``device_memory_bytes`` reads the card's own capacity when one is
present, for the dry-run's fit check.
"""
from __future__ import annotations

# dense bf16 tensor-core rate and float32 rate outside the tensor cores
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
PEAK_FLOPS_F32 = 67e12    # FLOP/s
# HBM3 bandwidth
HBM_BANDWIDTH = 3.35e12   # B/s
# device memory of one card, as sold (80 GB)
HBM_BYTES_PER_CARD = 80 * 10**9

# the mesh axis names of the port (``models.policy``, ``launch.mesh``)
AXIS_DATA = "data"
AXIS_MODEL = "model"
MESH_AXES = (AXIS_DATA, AXIS_MODEL)


def device_memory_bytes(device: int = 0) -> int:
    """The memory of card ``device`` as torch reports it
    (``get_device_properties(...).total_memory``) when a card is present,
    else ``HBM_BYTES_PER_CARD``."""
    import torch

    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(device).total_memory)
    return HBM_BYTES_PER_CARD
