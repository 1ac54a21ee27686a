"""Two-phase (CO2/brine) scenario inputs: geomodel and injection wells.

The numpy parts of ``repro.data.pde.two_phase`` that serving needs to build
scenarios, plus ``geomodel_channel`` from ``repro.launch.datagen``, so the
port's scenarios are byte-identical to the reference's. The IMPES
simulator itself belongs to a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TwoPhaseConfig:
    """The scenario-shape fields of the reference's config (the simulator's
    physical parameters come with the simulator, in a later slice)."""

    grid: Tuple[int, int, int] = (32, 16, 8)   # (nx, ny, nz), z down
    nt_frames: int = 8


def make_geomodel(cfg: TwoPhaseConfig, seed: int = 0):
    """Layered lognormal permeability + thin low-perm barriers; porosity.
    Returns float32 numpy arrays (k, phi) of shape ``cfg.grid``."""
    rng = np.random.default_rng(seed)
    nx, ny, nz = cfg.grid
    base = rng.lognormal(mean=0.0, sigma=0.4, size=(nx, ny, nz))
    layers = np.exp(0.8 * np.sin(np.linspace(0, 3 * np.pi, nz)))[None, None, :]
    k = base * layers
    for zb in range(2, nz, 3):  # shale streaks every ~3 cells
        k[:, :, zb] *= 0.05
    phi = 0.2 + 0.05 * (k / k.max())
    return k.astype(np.float32), phi.astype(np.float32)


def random_well_mask(cfg: TwoPhaseConfig, n_wells: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nx, ny, nz = cfg.grid
    mask = np.zeros(cfg.grid, np.float32)
    for _ in range(n_wells):
        i = rng.integers(2, nx - 2)
        j = rng.integers(2, ny - 2)
        mask[i, j, nz - 3 :] = 1.0  # perforate near the bottom
    return mask


def geomodel_channel(grid, nt: int, seed: int = 0) -> np.ndarray:
    """The shared log-permeability geomodel as a [1, nx, ny, nz, nt] input
    channel, repeated along t — the construction the reference's datagen
    uses, so an ensemble's geomodel is byte-identical across scenarios."""
    k, _ = make_geomodel(TwoPhaseConfig(grid=tuple(grid)), seed=seed)
    logk = np.log(k)
    return np.repeat(logk[None, :, :, :, None], nt, axis=-1).astype(np.float32)
