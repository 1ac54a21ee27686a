"""4-D FFT with frequency truncation (S ∘ F and its adjoint): the serial
oracle, the 1-D distributed schedules of the paper's Algorithm 2 and the
2-D pencil schedules.

Port of ``repro.core.dfft``. Conventions match it exactly:

  * data layout X[b, c, x, y, z, t], real input;
  * rFFT along the trailing time dim (keep the first m_t bins);
  * full FFT along x, y, z: truncation keeps the m lowest positive and the
    m highest (negative) frequencies -> 2m coefficients per dim;
  * S^T is zero-padding back into the middle of the spectrum.

The JAX package composes a 1-D rFFT and a 3-D FFT because XLA lowers FFTs
of rank <= 3 only; ``torch.fft.rfftn``/``irfftn`` over dims (2, 3, 4, 5)
compute the same transforms in one call (cuFFT on the card). The
distributed schedules cannot: each truncates some dims before the
all-to-all and transforms the others after it, so they keep the
reference's separate per-dim FFTs in its order.

The distributed half takes an explicit process group where the reference
takes a mesh-axis name (call it on every rank of the group, x sharded
along XDIM): the paper schedule, the eager schedule and Grady et al.'s
[31] untruncated schedule, each with ``comm_chunks``; and the 2-D pencil
schedules (paper and eager) over a pair of groups, x sharded along XDIM
over the first and y along YDIM over the second.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.partition import gather_dim, local_slice
from repro_torch.core.repartition import apply_chunked, repartition

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


# ---------------------------------------------------------------------------
# Communication/compute overlap: every op of the distributed pipelines (FFTs
# over spatial/time dims, truncate/pad slices, all-to-alls) treats the
# channel dim as a batch dim, so running the whole pipeline per channel
# slice and concatenating is bit-identical to the unchunked call.
# ---------------------------------------------------------------------------

def _chunk_channels(fn, x: torch.Tensor, chunks: int) -> torch.Tensor:
    return apply_chunked(fn, x, chunks, CDIM)


def _rfft_t(x: torch.Tensor) -> torch.Tensor:
    return torch.fft.rfft(x.to(torch.float32), dim=TDIM)


def _irfft_t(xf: torch.Tensor, nt: int, out_dtype) -> torch.Tensor:
    return torch.fft.irfft(xf, n=nt, dim=TDIM).to(out_dtype)


# ---------------------------------------------------------------------------
# Paper Algorithm 2 (x sharded along XDIM over ``group``).
# ---------------------------------------------------------------------------

def dist_forward(
    x: torch.Tensor, modes: Sequence[int], group, *, trunc_x: bool = True, comm_chunks: int = 1
) -> torch.Tensor:
    """Paper Alg. 2 forward transform: S_x F_x R_{x->y} S_{yzt} F_{yzt}.

    In: local real [b, c, nx/P, ny, nz, nt].
    Out: local complex [b, c, 2mx, 2my/P, 2mz, mt] (``trunc_x=False`` skips
    the final S_x, which the fused kernel does, leaving x at full size nx).

    Truncation along y/z/t happens BEFORE the repartition: the paper's
    communication optimization.
    """
    mx, my, mz, mt = modes

    def body(x):
        xf = _rfft_t(x)
        xf = torch.fft.fft(xf, dim=YDIM)
        xf = torch.fft.fft(xf, dim=ZDIM)
        xf = truncate_full(xf, YDIM, my)
        xf = truncate_full(xf, ZDIM, mz)
        xf = truncate_rfft(xf, TDIM, mt)
        xf = repartition(xf, XDIM, YDIM, group)
        xf = torch.fft.fft(xf, dim=XDIM)
        return truncate_full(xf, XDIM, mx) if trunc_x else xf

    return _chunk_channels(body, x, comm_chunks)


def dist_adjoint(
    xf: torch.Tensor,
    grid: Sequence[int],
    group,
    out_dtype: torch.dtype = torch.float32,
    *,
    pad_x: bool = True,
    comm_chunks: int = 1,
) -> torch.Tensor:
    """Paper Alg. 2 inverse: F_{yzt}^T S_{yzt}^T R^T F_x^T S_x^T.

    In: local complex [b, c, 2mx, 2my/P, 2mz, mt] (x already full size when
    ``pad_x=False``: the fused kernel zero-filled S_x^T). Out: local real
    [b, c, nx/P, ny, nz, nt].
    """
    nx, ny, nz, nt = grid

    def body(xf):
        xf = pad_full(xf, XDIM, nx) if pad_x else xf
        xf = torch.fft.ifft(xf, dim=XDIM)
        xf = repartition(xf, YDIM, XDIM, group)
        xf = pad_full(xf, YDIM, ny)
        xf = pad_full(xf, ZDIM, nz)
        xf = pad_rfft(xf, TDIM, nt // 2 + 1)
        xf = torch.fft.ifft(xf, dim=YDIM)
        xf = torch.fft.ifft(xf, dim=ZDIM)
        return _irfft_t(xf, nt, out_dtype)

    return _chunk_channels(body, xf, comm_chunks)


# ---------------------------------------------------------------------------
# Eager truncation (beyond the paper): each dim is truncated right after its
# own FFT, so later FFTs run on already-truncated tensors. Truncation along
# one dim commutes with an FFT along another, so this equals Alg. 2 with
# fewer FFT flops; the all-to-all moves the same tensor.
# ---------------------------------------------------------------------------

def dist_forward_eager(
    x: torch.Tensor, modes: Sequence[int], group, *, trunc_x: bool = True, comm_chunks: int = 1
) -> torch.Tensor:
    """Like dist_forward, with per-dim eager truncation."""
    mx, my, mz, mt = modes

    def body(x):
        xf = truncate_rfft(_rfft_t(x), TDIM, mt)
        xf = truncate_full(torch.fft.fft(xf, dim=ZDIM), ZDIM, mz)
        xf = truncate_full(torch.fft.fft(xf, dim=YDIM), YDIM, my)
        xf = repartition(xf, XDIM, YDIM, group)
        xf = torch.fft.fft(xf, dim=XDIM)
        return truncate_full(xf, XDIM, mx) if trunc_x else xf

    return _chunk_channels(body, x, comm_chunks)


def dist_adjoint_eager(
    xf: torch.Tensor,
    grid: Sequence[int],
    group,
    out_dtype: torch.dtype = torch.float32,
    *,
    pad_x: bool = True,
    comm_chunks: int = 1,
) -> torch.Tensor:
    """Adjoint of the eager schedule: each pad right before its own iFFT."""
    nx, ny, nz, nt = grid

    def body(xf):
        xf = pad_full(xf, XDIM, nx) if pad_x else xf
        xf = torch.fft.ifft(xf, dim=XDIM)
        xf = repartition(xf, YDIM, XDIM, group)
        xf = torch.fft.ifft(pad_full(xf, YDIM, ny), dim=YDIM)
        xf = torch.fft.ifft(pad_full(xf, ZDIM, nz), dim=ZDIM)
        return _irfft_t(pad_rfft(xf, TDIM, nt // 2 + 1), nt, out_dtype)

    return _chunk_channels(body, xf, comm_chunks)


# ---------------------------------------------------------------------------
# Grady et al. [31] baseline: repartition FIRST, truncate AFTER. Moves the
# spectrum untruncated along y/z/t: the paper's comparison point for its
# communication reduction.
# ---------------------------------------------------------------------------

def _truncate_y(xf: torch.Tensor, my: int, group) -> torch.Tensor:
    kept = truncate_full(gather_dim(xf, YDIM, group), YDIM, my)
    return local_slice(kept, YDIM, group).contiguous()


def _pad_y(xf: torch.Tensor, ny: int, group) -> torch.Tensor:
    padded = pad_full(gather_dim(xf, YDIM, group), YDIM, ny)
    return local_slice(padded, YDIM, group).contiguous()


class _TruncateY(torch.autograd.Function):
    """S_y on a y-sharded spectrum; its adjoint S_y^T is ``_pad_y``."""

    @staticmethod
    def forward(ctx, xf, my, group):
        ctx.ny, ctx.group = xf.shape[YDIM] * dist.get_world_size(group), group
        return _truncate_y(xf, my, group)

    @staticmethod
    def backward(ctx, g):
        return _pad_y(g, ctx.ny, ctx.group), None, None


class _PadY(torch.autograd.Function):
    """S_y^T on a y-sharded kept spectrum; its adjoint S_y is ``_truncate_y``."""

    @staticmethod
    def forward(ctx, xf, ny, group):
        ctx.my, ctx.group = xf.shape[YDIM] * dist.get_world_size(group) // 2, group
        return _pad_y(xf, ny, group)

    @staticmethod
    def backward(ctx, g):
        return _truncate_y(g, ctx.my, ctx.group), None, None


def truncate_y_local(xf: torch.Tensor, my: int, group) -> torch.Tensor:
    """Truncate the (sharded) y dim to this rank's slice of the kept modes.

    With y sharded P ways, the kept modes [:my] + [-my:] live on the first
    and last shards, so each rank gathers the whole y extent
    (``dist.all_gather_into_tensor``), truncates, and keeps its slice, at
    ``dist.get_rank(group)``. Only the [31] baseline uses it.
    Differentiable: its backward is ``pad_y_local``'s forward.
    """
    if torch.is_grad_enabled() and xf.requires_grad:
        return _TruncateY.apply(xf, my, group)
    return _truncate_y(xf, my, group)


def pad_y_local(xf: torch.Tensor, ny: int, group) -> torch.Tensor:
    """Adjoint of ``truncate_y_local``: gather the kept y modes, zero-fill
    the middle back to ``ny``, keep this rank's slice."""
    if torch.is_grad_enabled() and xf.requires_grad:
        return _PadY.apply(xf, ny, group)
    return _pad_y(xf, ny, group)


def dist_forward_untruncated(
    x: torch.Tensor, modes: Sequence[int], group, *, trunc_xzt: bool = True, comm_chunks: int = 1
) -> torch.Tensor:
    """[31]-style forward: F_{yzt}, R_{x->y} (full tensor), F_x, then S.

    ``trunc_xzt=False`` leaves x/z/t untruncated for the fused kernel; the
    sharded y dim is still truncated here (it needs the collective, and
    truncation along y commutes with the kernel's x/z/t truncation).
    """
    mx, my, mz, mt = modes

    def body(x):
        xf = _rfft_t(x)
        xf = torch.fft.fft(xf, dim=YDIM)
        xf = torch.fft.fft(xf, dim=ZDIM)
        xf = repartition(xf, XDIM, YDIM, group)
        xf = torch.fft.fft(xf, dim=XDIM)
        if not trunc_xzt:
            return truncate_y_local(xf, my, group)
        xf = truncate_full(xf, XDIM, mx)  # before the y gather: less data
        xf = truncate_y_local(xf, my, group)
        xf = truncate_full(xf, ZDIM, mz)
        return truncate_rfft(xf, TDIM, mt)

    return _chunk_channels(body, x, comm_chunks)


def dist_adjoint_untruncated(
    xf: torch.Tensor,
    grid: Sequence[int],
    group,
    out_dtype: torch.dtype = torch.float32,
    *,
    pad_xzt: bool = True,
    comm_chunks: int = 1,
) -> torch.Tensor:
    """[31]-style inverse: pad everything first, repartition the full tensor.

    ``pad_xzt=False`` means x/z/t arrive full size (the fused kernel
    zero-filled them); only the sharded y dim still needs its collective pad.
    """
    nx, ny, nz, nt = grid

    def body(xf):
        if pad_xzt:
            xf = pad_full(xf, XDIM, nx)
            xf = pad_y_local(xf, ny, group)
            xf = pad_full(xf, ZDIM, nz)
            xf = pad_rfft(xf, TDIM, nt // 2 + 1)
        else:
            xf = pad_y_local(xf, ny, group)
        xf = torch.fft.ifft(xf, dim=XDIM)
        xf = repartition(xf, YDIM, XDIM, group)
        xf = torch.fft.ifft(xf, dim=YDIM)
        xf = torch.fft.ifft(xf, dim=ZDIM)
        return _irfft_t(xf, nt, out_dtype)

    return _chunk_channels(body, xf, comm_chunks)


# ---------------------------------------------------------------------------
# 2-D pencil decomposition: x sharded over ``groups[0]`` (Px ranks) and y
# over ``groups[1]`` (Py ranks). Two repartitions, each over one group:
#
#   [b,c, nx/Px, ny/Py, nz,     nt ]   local input pencil
#   [b,c, nx/Px, ny/Py, 2mz,    mt ]   F_{zt}, S_{zt} (unsharded dims)
#   [b,c, nx/Px, ny,    2mz/Py, mt ]   R^{my}: y-shard moves to z
#   [b,c, nx/Px, 2my,   2mz/Py, mt ]   F_y, S_y
#   [b,c, nx,    2my/Px,2mz/Py, mt ]   R^{mx}: x-shard moves to y
#   [b,c, 2mx,   2my/Px,2mz/Py, mt ]   F_x, S_x; weights sharded k_y x k_z
#
# Divisibility: Px | nx, Px | 2my, Py | ny, Py | 2mz.
# ---------------------------------------------------------------------------

def dist_forward_2d(
    x: torch.Tensor, modes: Sequence[int], groups: Tuple[object, object], *,
    trunc_x: bool = True, comm_chunks: int = 1,
) -> torch.Tensor:
    """Pencil-decomposed forward transform.

    In: local real [b, c, nx/Px, ny/Py, nz, nt], x sharded over
    ``groups[0]`` and y over ``groups[1]``.
    Out: local complex [b, c, 2mx, 2my/Px, 2mz/Py, mt] (x at full size nx
    with ``trunc_x=False``).
    """
    g_x, g_y = groups
    mx, my, mz, mt = modes

    def body(x):
        # F_{zt}, S_{zt}: both dims are unsharded on every pencil
        xf = _rfft_t(x)
        xf = torch.fft.fft(xf, dim=ZDIM)
        xf = truncate_full(xf, ZDIM, mz)
        xf = truncate_rfft(xf, TDIM, mt)
        # R^{my}_{y->z}: unshard y by sharding the (truncated) z dim
        xf = repartition(xf, YDIM, ZDIM, g_y)
        xf = torch.fft.fft(xf, dim=YDIM)
        xf = truncate_full(xf, YDIM, my)
        # R^{mx}_{x->y}: unshard x by sharding the (truncated) y dim
        xf = repartition(xf, XDIM, YDIM, g_x)
        xf = torch.fft.fft(xf, dim=XDIM)
        return truncate_full(xf, XDIM, mx) if trunc_x else xf

    return _chunk_channels(body, x, comm_chunks)


def dist_adjoint_2d(
    xf: torch.Tensor, grid: Sequence[int], groups: Tuple[object, object],
    out_dtype: torch.dtype = torch.float32, *, pad_x: bool = True, comm_chunks: int = 1,
) -> torch.Tensor:
    """Adjoint of ``dist_forward_2d`` (each R^T is the reverse all-to-all).

    In: local complex [b, c, 2mx, 2my/Px, 2mz/Py, mt] (x at full size with
    ``pad_x=False``). Out: local real [b, c, nx/Px, ny/Py, nz, nt].
    """
    g_x, g_y = groups
    nx, ny, nz, nt = grid

    def body(xf):
        xf = pad_full(xf, XDIM, nx) if pad_x else xf
        xf = torch.fft.ifft(xf, dim=XDIM)
        xf = repartition(xf, YDIM, XDIM, g_x)
        xf = pad_full(xf, YDIM, ny)
        xf = torch.fft.ifft(xf, dim=YDIM)
        xf = repartition(xf, ZDIM, YDIM, g_y)
        xf = pad_full(xf, ZDIM, nz)
        xf = pad_rfft(xf, TDIM, nt // 2 + 1)
        xf = torch.fft.ifft(xf, dim=ZDIM)
        return _irfft_t(xf, nt, out_dtype)

    return _chunk_channels(body, xf, comm_chunks)


def dist_forward_2d_eager(
    x: torch.Tensor, modes: Sequence[int], groups: Tuple[object, object], *,
    trunc_x: bool = True, comm_chunks: int = 1,
) -> torch.Tensor:
    """2-D pencil forward with per-dim eager truncation: t is truncated
    before the z FFT, so the z FFT runs on an mt-deep tensor (the same
    transform as ``dist_forward_2d``)."""
    g_x, g_y = groups
    mx, my, mz, mt = modes

    def body(x):
        xf = truncate_rfft(_rfft_t(x), TDIM, mt)
        xf = truncate_full(torch.fft.fft(xf, dim=ZDIM), ZDIM, mz)
        xf = repartition(xf, YDIM, ZDIM, g_y)
        xf = truncate_full(torch.fft.fft(xf, dim=YDIM), YDIM, my)
        xf = repartition(xf, XDIM, YDIM, g_x)
        xf = torch.fft.fft(xf, dim=XDIM)
        return truncate_full(xf, XDIM, mx) if trunc_x else xf

    return _chunk_channels(body, x, comm_chunks)


def dist_adjoint_2d_eager(
    xf: torch.Tensor, grid: Sequence[int], groups: Tuple[object, object],
    out_dtype: torch.dtype = torch.float32, *, pad_x: bool = True, comm_chunks: int = 1,
) -> torch.Tensor:
    """Adjoint of the eager 2-D schedule: each pad happens right before its
    own iFFT, so earlier iFFTs run on still-truncated tensors."""
    g_x, g_y = groups
    nx, ny, nz, nt = grid

    def body(xf):
        xf = pad_full(xf, XDIM, nx) if pad_x else xf
        xf = torch.fft.ifft(xf, dim=XDIM)
        xf = repartition(xf, YDIM, XDIM, g_x)
        xf = torch.fft.ifft(pad_full(xf, YDIM, ny), dim=YDIM)
        xf = repartition(xf, ZDIM, YDIM, g_y)
        xf = torch.fft.ifft(pad_full(xf, ZDIM, nz), dim=ZDIM)
        return _irfft_t(pad_rfft(xf, TDIM, nt // 2 + 1), nt, out_dtype)

    return _chunk_channels(body, xf, comm_chunks)
