"""4-D FFT with frequency truncation (S ∘ F and its adjoint), serial half.

Port of ``repro.core.dfft``'s serial oracle. Conventions match it exactly:

  * data layout X[b, c, x, y, z, t], real input;
  * rFFT along the trailing time dim (keep the first m_t bins);
  * full FFT along x, y, z: truncation keeps the m lowest positive and the
    m highest (negative) frequencies -> 2m coefficients per dim;
  * S^T is zero-padding back into the middle of the spectrum.

The JAX package composes a 1-D rFFT and a 3-D FFT because XLA lowers FFTs
of rank <= 3 only; ``torch.fft.rfftn``/``irfftn`` over dims (2, 3, 4, 5)
compute the same transforms in one call (cuFFT on the card).
"""
from __future__ import annotations

from typing import Sequence

import torch

# Dim indices in the canonical [b, c, x, y, z, t] layout.
BDIM, CDIM, XDIM, YDIM, ZDIM, TDIM = range(6)
SPATIAL_DIMS = (XDIM, YDIM, ZDIM, TDIM)


def truncate_full(x: torch.Tensor, axis: int, m: int) -> torch.Tensor:
    """Keep 2m lowest-|k| modes of a full FFT dim: [:m] and [-m:]."""
    n = x.shape[axis]
    if 2 * m > n:
        raise ValueError(f"2m={2*m} exceeds dim size {n}")
    return torch.cat([x.narrow(axis, 0, m), x.narrow(axis, n - m, m)], dim=axis)


def pad_full(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """Adjoint of truncate_full: zero-fill the middle back to size n."""
    two_m = x.shape[axis]
    m = two_m // 2
    shape = list(x.shape)
    shape[axis] = n - two_m
    zeros = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat(
        [x.narrow(axis, 0, m), zeros, x.narrow(axis, m, two_m - m)], dim=axis
    )


def truncate_rfft(x: torch.Tensor, axis: int, m: int) -> torch.Tensor:
    """Keep the first m bins of an rFFT dim."""
    return x.narrow(axis, 0, m)


def pad_rfft(x: torch.Tensor, axis: int, n_bins: int) -> torch.Tensor:
    """Adjoint of truncate_rfft: zero-pad the tail back to n_bins."""
    shape = list(x.shape)
    shape[axis] = n_bins - x.shape[axis]
    zeros = torch.zeros(shape, dtype=x.dtype, device=x.device)
    return torch.cat([x, zeros], dim=axis)


def truncate_modes(
    xf: torch.Tensor, modes: Sequence[int], axes: Sequence[int] = SPATIAL_DIMS
) -> torch.Tensor:
    """Truncate all spatial dims; the last axis in ``axes`` is the rFFT dim."""
    *full_axes, rfft_axis = axes
    for axis, m in zip(full_axes, modes[: len(full_axes)]):
        xf = truncate_full(xf, axis, m)
    return truncate_rfft(xf, rfft_axis, modes[-1]).contiguous()


def pad_modes(
    xf: torch.Tensor,
    full_sizes: Sequence[int],
    axes: Sequence[int] = SPATIAL_DIMS,
) -> torch.Tensor:
    """Adjoint of truncate_modes. full_sizes includes the rFFT bin count."""
    *full_axes, rfft_axis = axes
    for axis, n in zip(full_axes, full_sizes[:-1]):
        xf = pad_full(xf, axis, n)
    return pad_rfft(xf, rfft_axis, full_sizes[-1])


def serial_forward(
    x: torch.Tensor, modes: Sequence[int], *, truncate: bool = True
) -> torch.Tensor:
    """rFFT over t and FFT over (x, y, z), then truncation.

    ``truncate=False`` returns the full spectrum — used by the fused
    spectral kernel, which performs S (and S^T) itself.
    """
    xf = torch.fft.rfftn(x.to(torch.float32), dim=SPATIAL_DIMS)
    if truncate:
        xf = truncate_modes(xf, modes)
    return xf


def serial_adjoint(
    xf: torch.Tensor,
    grid: Sequence[int],
    out_dtype: torch.dtype = torch.float32,
    *,
    pre_padded: bool = False,
) -> torch.Tensor:
    """Zero-pad then inverse transform; grid is the real-space (nx,ny,nz,nt).

    ``pre_padded=True`` means ``xf`` is already the full-size spectrum (the
    fused kernel zero-fills S^T itself) — skip pad_modes.
    """
    nx, ny, nz, nt = grid
    full = xf if pre_padded else pad_modes(xf, (nx, ny, nz, nt // 2 + 1))
    y = torch.fft.irfftn(full, s=(nx, ny, nz, nt), dim=SPATIAL_DIMS)
    return y.to(out_dtype)
