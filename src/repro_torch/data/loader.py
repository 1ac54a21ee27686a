"""Per-channel normalization from persisted store stats.

The port's copy of ``Normalizer`` and ``NORMALIZER_KINDS`` from
``repro.data.loader`` (pure numpy there too, but that module imports JAX).
The sharded dataset loader itself belongs to a later slice.
"""
from __future__ import annotations

import numpy as np

NORMALIZER_KINDS = ("meanstd", "absmax")


class Normalizer:
    """Invertible per-channel affine normalizer from persisted store stats.

    The ``normalizer`` kind in a store's ``meta.json`` selects the scheme:
    ``meanstd`` (default) encodes ``(x - mean) / std`` from the Welford
    stats; ``absmax`` encodes ``x / absmax``. ``decode`` inverts, which is
    what serving uses to return predictions in physical units. Stats arrays
    are shaped to broadcast over ``[b, c, *spatial]``.
    """

    def __init__(self, mean, scale, identity: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.scale = np.asarray(scale, np.float32)
        self.identity = identity

    @classmethod
    def from_stats(cls, stats, kind: str = "meanstd", ndim: int = 6) -> "Normalizer":
        if not stats:
            return cls(0.0, 1.0, identity=True)
        if kind not in NORMALIZER_KINDS:
            raise ValueError(
                f"unknown normalizer kind {kind!r}; expected one of "
                f"{NORMALIZER_KINDS}"
            )
        bshape = (1, -1) + (1,) * (ndim - 2)
        if kind == "absmax":
            if "absmax" not in stats:
                raise ValueError(
                    "normalizer 'absmax' requested but the persisted stats "
                    "carry no 'absmax' field (regenerate the store with the "
                    "current datagen, which tracks per-channel max|x|)"
                )
            mean = np.zeros(len(stats["absmax"]), np.float32).reshape(bshape)
            scale = np.maximum(
                np.asarray(stats["absmax"], np.float32).reshape(bshape), 1e-6
            )
        else:
            mean = np.asarray(stats["mean"], np.float32).reshape(bshape)
            scale = np.maximum(
                np.asarray(stats["std"], np.float32).reshape(bshape), 1e-6
            )
        return cls(mean, scale)

    def encode(self, x: np.ndarray) -> np.ndarray:
        return np.asarray((x - self.mean) / self.scale, np.float32)

    def decode(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y * self.scale + self.mean, np.float32)
