"""Public wrappers of the spectral convolution and its gradient.

Port of ``repro.kernels.spectral_conv.ops``: the fused path
(``spectral_apply_fused``) and the flattened-K path (``spectral_apply``).
The path is chosen by where the tensors lie, and by nothing else: CUDA
tensors go to the hand-written kernels (``csrc/spectral_fused.cu``,
``csrc/spectral_fused_dw.cu``, ``csrc/spectral_apply.cu``,
``csrc/spectral_dw.cu``), CPU tensors — which only a caller that asked
for the CPU has — to the plain versions in ``ref``. There is no fallback
from a kernel to its plain version: a failed build or launch raises.

The fused op is differentiable (``_FusedSpectral``, the counterpart of the
reference's ``custom_vjp`` in ``_fused_vjp``), in torch's ``.grad``
convention, which is the conjugate of JAX's cotangent:

  * dx = the fused kernel run on the output cotangent g with conj(W^T)
    (ci and co swapped), padded back to x's t extent;
  * dW = the weight-cotangent kernel, conj(S(x)) ._b S(g);
  * d(add) = S(g), the kept positions of g, for the ``add`` variant.

The kernels read complex64 in place (``torch.view_as_real`` layout, re/im
interleaved), so the JAX package's re/im weight planes and its plane cache
(``cached_weight_planes``, ``params_with_planes``) have no counterpart
here: they exist there only because the TPU kernels take float32 planes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.spectral_conv.build import load_library
from repro_torch.kernels.spectral_conv.ref import (
    gather_kept_ref,
    pad_kept_ref,
    spectral_apply_fused_ref,
    spectral_apply_ref,
    spectral_dw_ref,
    spectral_fused_dw_ref,
)


def _validate_fused(x_shape, w_shape, trunc, t_out):
    """Shape checks of the fused op, worded as the reference's."""
    if len(x_shape) != 6 or len(w_shape) != 6:
        raise ValueError(
            f"x {tuple(x_shape)} and w {tuple(w_shape)} must both be 6-D"
        )
    if len(trunc) != 3:
        raise ValueError(f"trunc {trunc} must have 3 entries")
    ci = x_shape[1]
    if w_shape[0] != ci:
        raise ValueError(f"w ci={w_shape[0]} != x ci={ci}")
    kt = w_shape[5]
    if x_shape[5] < kt:
        raise ValueError(f"x time bins {x_shape[5]} < weight kt={kt}")
    if t_out is not None and t_out < kt:
        raise ValueError(f"t_out={t_out} < weight kt={kt}")
    for d in range(3):
        e, k, n = x_shape[2 + d], w_shape[2 + d], trunc[d]
        if n is None:
            if e != k:
                raise ValueError(
                    f"dim {d}: pre-truncated input extent {e} != kept {k}"
                )
        else:
            if e != n:
                raise ValueError(f"dim {d}: input extent {e} != full size {n}")
            if k % 2 or k < 2:
                raise ValueError(f"dim {d}: kept extent {k} must be even >= 2")
            if k > n:
                raise ValueError(f"dim {d}: kept {k} > full {n}")


def _validate_dw(x_shape, g_shape, trunc, kept):
    """Shape checks of the weight cotangent: the reference's time-bin check
    (worded as ``kernel.py``'s), then those of the forward it inverts."""
    kt = kept[3]
    if x_shape[5] < kt or g_shape[5] < kt:
        raise ValueError(f"time bins {x_shape[5]}/{g_shape[5]} < kt={kt}")
    if len(g_shape) != 6 or tuple(g_shape[:1]) + tuple(g_shape[2:5]) != (
        tuple(x_shape[:1]) + tuple(x_shape[2:5])
    ):
        raise ValueError(
            f"g {tuple(g_shape)} must match x {tuple(x_shape)} in batch and "
            f"spatial extents"
        )
    _validate_fused(x_shape, (x_shape[1], g_shape[1]) + tuple(kept), trunc, None)


def _check_operands(named, strided=("xf",)):
    """Raise on what the kernels do not take: mixed devices, dtypes other
    than complex64, and on the card a non-contiguous operand other than
    those named in ``strided`` (which the kernels read through their
    strides). Returns the common device."""
    devices = {t.device for _, t in named}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for name, t in named:
        if t.dtype != torch.complex64:
            raise ValueError(f"{name} dtype {t.dtype} != torch.complex64")
        if device.type == "cuda" and name not in strided and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    return device


def _raw(t: torch.Tensor) -> torch.Tensor:
    """The tensor with its lazy conjugate/negative bits applied: the
    kernels read raw memory, so a ``.conj()`` view would be read unconjugated."""
    return t.resolve_conj().resolve_neg()


def _raise_on(lib, kernel: str, err: int):
    if err:
        raise RuntimeError(
            f"{kernel} kernel launch failed: "
            + lib.spectral_fused_error_string(err).decode()
        )


def spectral_fused_cuda(xf, w, trunc, t_out=None, add=None, *, conj_transpose=False):
    """Launch the fused kernel on PyTorch's current stream (no synchronise).

    ``conj_transpose=True`` runs it on conj(W^T) without forming it: ``w``
    stays the forward's [ci, co, K...] tensor, ``xf`` has co channels and
    the result ci (the backward's dx). Operands are validated by the
    caller. ``spectral_fused_cuda.launches`` counts the launches, so a run
    can show its main path went through the kernel.
    """
    xf, w = _raw(xf), _raw(w)
    add = None if add is None else _raw(add)
    b, _, e1, e2, e3 = xf.shape[:5]
    k1, k2, k3, kt = w.shape[2:]
    n_kept = k1 * k2 * k3 * kt
    if conj_transpose:
        co, ci = w.shape[:2]
        w_in, w_out = n_kept, w.shape[1] * n_kept
    else:
        ci, co = w.shape[:2]
        w_in, w_out = co * n_kept, n_kept
    tout = kt if t_out is None else int(t_out)
    y = torch.empty((b, co, e1, e2, e3, tout), dtype=torch.complex64, device=xf.device)
    n = [-1 if v is None else int(v) for v in trunc]
    strides = (ctypes.c_longlong * 6)(*xf.stride())
    lib = load_library()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        err = lib.spectral_fused_launch(
            xf.data_ptr(), w.data_ptr(),
            None if add is None else add.data_ptr(), y.data_ptr(),
            b, ci, co, e1, e2, e3, k1, k2, k3, kt, tout, *n, strides,
            w_in, w_out, int(conj_transpose), stream,
        )
    _raise_on(lib, "spectral_fused", err)
    spectral_fused_cuda.launches += 1
    return y


spectral_fused_cuda.launches = 0


def spectral_fused_dw_cuda(xf, g, trunc, kept) -> torch.Tensor:
    """Launch the weight-cotangent kernel on PyTorch's current stream (no
    synchronise); operands validated by the caller. Counts its launches on
    ``spectral_fused_dw_cuda.launches``."""
    xf, g = _raw(xf), _raw(g)
    b, ci = xf.shape[:2]
    co = g.shape[1]
    kept = tuple(int(k) for k in kept)
    w = torch.empty((ci, co) + kept, dtype=torch.complex64, device=xf.device)
    n = [-1 if v is None else int(v) for v in trunc]
    xs = (ctypes.c_longlong * 6)(*xf.stride())
    gs = (ctypes.c_longlong * 6)(*g.stride())
    lib = load_library()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        err = lib.spectral_fused_dw_launch(
            xf.data_ptr(), g.data_ptr(), w.data_ptr(),
            b, ci, co, *kept, *n, xs, gs, stream,
        )
    _raise_on(lib, "spectral_fused_dw", err)
    spectral_fused_dw_cuda.launches += 1
    return w


spectral_fused_dw_cuda.launches = 0


def _mix(xf, w, trunc, t_out, add, conj_transpose=False):
    """The fused op (or, with ``conj_transpose``, its input cotangent) on
    the kernel or the plain version, by where the tensors lie."""
    w_shape = (
        (w.shape[1], w.shape[0]) + tuple(w.shape[2:]) if conj_transpose else w.shape
    )
    _validate_fused(xf.shape, w_shape, trunc, t_out)
    named = [("xf", xf), ("w", w)] + ([("add", add)] if add is not None else [])
    device = _check_operands(named)
    if add is not None:
        want = (xf.shape[0], w_shape[1]) + tuple(w_shape[2:])
        if tuple(add.shape) != want:
            raise ValueError(f"add shape {tuple(add.shape)} != {want}")
    if device.type == "cuda":
        return spectral_fused_cuda(xf, w, trunc, t_out, add, conj_transpose=conj_transpose)
    if conj_transpose:
        w = w.transpose(0, 1).conj()
    y = spectral_apply_fused_ref(xf, w, trunc, t_out)
    if add is not None:
        y = y + pad_kept_ref(add, trunc, t_out)
    return y


def spectral_fused_dx(g, w, trunc, t_out) -> torch.Tensor:
    """Input cotangent of the fused op in torch's convention: the fused op
    run on the output cotangent ``g`` [b, co, E1, E2, E3, Tg] with conj(W^T)
    (``w`` stays [ci, co, K...]), padded to ``t_out`` time bins. Returns
    [b, ci, E1, E2, E3, t_out]."""
    return _mix(g, w, tuple(trunc), t_out, None, conj_transpose=True)


def spectral_fused_dw(xf, g, trunc, kept) -> torch.Tensor:
    """Weight cotangent of the fused op in torch's convention:
    ``w_bar[ci, co, k] = sum_b conj(S(x))[b, ci, k] * S(g)[b, co, k]``.

    xf: [b, ci, E1, E2, E3, Tx] the spectrum the forward consumed; g: [b,
    co, E1, E2, E3, Tg] the cotangent of its output (any strides on the
    card); ``kept`` = (K1, K2, K3, KT). Returns [ci, co, K1, K2, K3, KT].
    """
    trunc, kept = tuple(trunc), tuple(int(k) for k in kept)
    _validate_dw(xf.shape, g.shape, trunc, kept)
    if _check_operands([("xf", xf), ("g", g)], strided=("xf", "g")).type == "cuda":
        return spectral_fused_dw_cuda(xf, g, trunc, kept)
    return spectral_fused_dw_ref(xf, g, trunc, kept)


class _FusedSpectral(torch.autograd.Function):
    """The fused op with its backward on the kernels (see the module
    docstring). Non-kept input positions were masked in the forward, so
    their cotangent is the zero the pad of dx re-inserts."""

    @staticmethod
    def forward(ctx, xf, w, add, trunc, t_out):
        ctx.save_for_backward(xf, w)
        ctx.trunc = trunc
        return _mix(xf, w, trunc, t_out, add)

    @staticmethod
    def backward(ctx, g):
        xf, w = ctx.saved_tensors
        trunc, kept = ctx.trunc, tuple(w.shape[2:])
        dx = dw = dadd = None
        if ctx.needs_input_grad[0]:
            dx = spectral_fused_dx(g, w, trunc, xf.shape[-1])
        if ctx.needs_input_grad[1]:
            dw = spectral_fused_dw(xf, g, trunc, kept)
        if ctx.needs_input_grad[2]:
            dadd = gather_kept_ref(g, trunc, kept)
        return dx, dw, dadd, None, None


def _fused(xf, w, trunc, t_out, add):
    trunc = tuple(trunc)
    operands = (xf, w) if add is None else (xf, w, add)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _FusedSpectral.apply(xf, w, add, trunc, t_out)
    return _mix(xf, w, trunc, t_out, add)


def spectral_apply_fused(xf, w, trunc, *, t_out: int | None = None) -> torch.Tensor:
    """Fused S^T (W ·) S: truncate + complex channel mix + zero-pad.

    xf: [b, ci, E1, E2, E3, T] complex64 spectrum. w: [ci, co, K1, K2, K3,
    KT] complex64 kept-mode weights. ``trunc[d]`` = full size N of spatial
    dim d (truncate/pad inside the op) or None if pre-truncated upstream.
    The trailing rFFT dim keeps bins [:KT] and pads back to ``t_out`` when
    given. Returns [b, co, E1, E2, E3, t_out or KT]. Differentiable in
    ``xf`` and ``w``.
    """
    return _fused(xf, w, trunc, t_out, None)


def spectral_apply_fused_add(
    xf, w, add, trunc, *, t_out: int | None = None
) -> torch.Tensor:
    """The fused op on the dynamic remainder ``xf`` plus a cached kept-mode
    static contribution ``add`` [b, co, K1, K2, K3, KT], summed on the kept
    positions. Padding is linear, so this equals
    pad(mix(trunc(xf))) + pad(add); the kernel does it in one pass.
    Differentiable in ``xf``, ``w`` and ``add``."""
    return _fused(xf, w, trunc, t_out, add)


def spectral_static_contribution(sf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Kept-mode static contribution C = W . S(h_static).

    sf: [b, ci, K1, K2, K3, KT] (or unbatched [ci, ...]) truncated kept-mode
    spectrum of the static activation; w: complex kept-mode weights. Outside
    any TPU kernel in the reference, so it stays a plain einsum.
    """
    unbatched = sf.ndim == w.ndim - 1
    if unbatched:
        sf = sf[None]
    y = spectral_apply_ref(sf, w)
    return y[0] if unbatched else y


# ---------------------------------------------------------------------------
# Flattened-K path: the mode dims are pre-truncated upstream.
# ---------------------------------------------------------------------------

def _mode_run_contiguous(t: torch.Tensor) -> bool:
    """Whether the mode dims (all but the first two) form one contiguous run."""
    return t.as_strided(t.shape[2:], t.stride()[2:]).is_contiguous()


def _check_flat(named):
    """Checks the flattened-K kernels need of their two operands
    [*, *, *modes]: one rank >= 3, the same mode extents, complex64 on one
    device (CPU or CUDA), and a contiguous run of modes (the first two dims
    may have any strides). Returns the device."""
    (a_name, a), (b_name, b) = named
    if a.ndim < 3 or b.ndim != a.ndim:
        raise ValueError(
            f"{a_name} {tuple(a.shape)} and {b_name} {tuple(b.shape)} must have "
            f"the same rank >= 3 (two leading dims, then the modes)"
        )
    if tuple(a.shape[2:]) != tuple(b.shape[2:]):
        raise ValueError(
            f"{b_name} modes {tuple(b.shape[2:])} != {a_name} modes {tuple(a.shape[2:])}"
        )
    device = _check_operands(named, strided=(a_name, b_name))
    for name, t in named:
        if not _mode_run_contiguous(t):
            raise ValueError(
                f"{name} strides {t.stride()}: its mode dims must form one contiguous run"
            )
    return device


def spectral_apply_cuda(xf, w, *, conj_transpose=False) -> torch.Tensor:
    """Launch the flattened-K mix kernel on PyTorch's current stream (no
    synchronise): y[b, co, K] = sum_ci xf[b, ci, K] w[ci, co, K].

    ``conj_transpose=True`` runs it on conj(W^T) without forming it: ``w``
    stays the forward's [ci, co, *modes] tensor, ``xf`` has co channels and
    the result ci (the backward's dx). Operands are validated by the caller.
    ``spectral_apply_cuda.launches`` counts the launches.
    """
    xf, w = _raw(xf), _raw(w)
    b, modes = xf.shape[0], tuple(xf.shape[2:])
    if conj_transpose:
        co, ci = w.shape[:2]
        w_in, w_out = w.stride(1), w.stride(0)
    else:
        ci, co = w.shape[:2]
        w_in, w_out = w.stride(0), w.stride(1)
    y = torch.empty((b, co) + modes, dtype=torch.complex64, device=xf.device)
    lib = load_library()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        err = lib.spectral_apply_launch(
            xf.data_ptr(), w.data_ptr(), y.data_ptr(), b, ci, co, math.prod(modes),
            xf.stride(0), xf.stride(1), w_in, w_out, int(conj_transpose), stream,
        )
    _raise_on(lib, "spectral_apply", err)
    spectral_apply_cuda.launches += 1
    return y


spectral_apply_cuda.launches = 0


def spectral_dw_cuda(xf, g) -> torch.Tensor:
    """Launch the flattened-K weight-cotangent kernel on PyTorch's current
    stream (no synchronise): w_bar[ci, co, K] = sum_b conj(xf[b, ci, K])
    g[b, co, K]. Operands validated by the caller. Counts its launches on
    ``spectral_dw_cuda.launches``."""
    xf, g = _raw(xf), _raw(g)
    b, ci, modes = xf.shape[0], xf.shape[1], tuple(xf.shape[2:])
    co = g.shape[1]
    w = torch.empty((ci, co) + modes, dtype=torch.complex64, device=xf.device)
    lib = load_library()
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        err = lib.spectral_dw_launch(
            xf.data_ptr(), g.data_ptr(), w.data_ptr(), b, ci, co, math.prod(modes),
            xf.stride(0), xf.stride(1), g.stride(0), g.stride(1), stream,
        )
    _raise_on(lib, "spectral_dw", err)
    spectral_dw_cuda.launches += 1
    return w


spectral_dw_cuda.launches = 0


def _flat_mix(xf, w, conj_transpose=False):
    """The flattened-K mix (or, with ``conj_transpose``, its input
    cotangent) on the kernel or the plain version, by where the tensors lie."""
    device = _check_flat([("xf", xf), ("w", w)])
    contracted = 1 if conj_transpose else 0
    if w.shape[contracted] != xf.shape[1]:
        raise ValueError(
            f"w dim {contracted} = {w.shape[contracted]} != xf channels {xf.shape[1]}"
        )
    if device.type == "cuda":
        return spectral_apply_cuda(xf, w, conj_transpose=conj_transpose)
    if conj_transpose:
        w = w.transpose(0, 1).conj()
    return spectral_apply_ref(xf, w)


def spectral_apply_dx(g, w) -> torch.Tensor:
    """Input cotangent of the flattened-K mix in torch's convention:
    dx[b, ci, *modes] = sum_co g[b, co, *modes] conj(w[ci, co, *modes]), the
    mix run on ``g`` with conj(W^T) (``w`` stays [ci, co, *modes])."""
    return _flat_mix(g, w, conj_transpose=True)


def spectral_apply_dw(xf, g) -> torch.Tensor:
    """Weight cotangent of the flattened-K mix in torch's convention:
    ``w_bar[ci, co, *modes] = sum_b conj(xf[b, ci, *modes]) g[b, co, *modes]``.
    xf: [b, ci, *modes]; g: [b, co, *modes]. Returns [ci, co, *modes]."""
    device = _check_flat([("xf", xf), ("g", g)])
    if g.shape[0] != xf.shape[0]:
        raise ValueError(f"g batch {g.shape[0]} != xf batch {xf.shape[0]}")
    if device.type == "cuda":
        return spectral_dw_cuda(xf, g)
    return spectral_dw_ref(xf, g)


class _FlatSpectral(torch.autograd.Function):
    """The flattened-K mix with its backward on the kernels: dx on the mix
    kernel with conj(W^T), dW on the weight-cotangent kernel. The
    counterpart of the reference's ``custom_vjp`` in ``_flat_vjp``."""

    @staticmethod
    def forward(ctx, xf, w):
        ctx.save_for_backward(xf, w)
        return _flat_mix(xf, w)

    @staticmethod
    def backward(ctx, g):
        xf, w = ctx.saved_tensors
        if not _mode_run_contiguous(g):  # e.g. the expanded cotangent of a sum
            g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = spectral_apply_dx(g, w)
        if ctx.needs_input_grad[1]:
            dw = spectral_apply_dw(xf, g)
        return dx, dw


def spectral_apply(xf, w) -> torch.Tensor:
    """Per-mode complex channel mix on pre-truncated modes.

    xf: [b, ci, *modes] complex64; w: [ci, co, *modes] complex64, any
    number of mode dims, which must form one contiguous run in memory (the
    batch and channel dims may have any strides). Returns [b, co, *modes]
    complex64. Differentiable in ``xf`` and ``w``.

    The reference's ``use_pallas``, ``block_k`` and ``interpret`` have no
    counterpart: the device of the tensors picks the kernel or the plain
    version, and the kernel has no block size to choose (it keeps K
    innermost and masks its ragged tail instead of padding it). Nor does
    the ``(wr, wi)`` planes tuple: the kernels read complex64 in place.
    """
    if torch.is_grad_enabled() and (xf.requires_grad or w.requires_grad):
        return _FlatSpectral.apply(xf, w)
    return _flat_mix(xf, w)
