"""Public wrappers of the fused spectral convolution.

Port of ``repro.kernels.spectral_conv.ops`` for serving (forward only).
The path is chosen by where the tensors lie, and by nothing else: CUDA
tensors go to the hand-written kernel (``csrc/spectral_fused.cu``), CPU
tensors — which only a caller that asked for the CPU has — to the plain
version in ``ref``. There is no fallback from the kernel to the plain
version.

The kernel reads complex64 in place (``torch.view_as_real`` layout, re/im
interleaved), so the JAX package's re/im weight planes and its plane cache
(``cached_weight_planes``, ``params_with_planes``) have no counterpart
here: they exist there only because the TPU kernel takes float32 planes.
The weight-gradient kernel (``spectral_fused_dw``) belongs to training and
is not ported yet.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.spectral_conv.build import load_library
from repro_torch.kernels.spectral_conv.ref import (
    pad_kept_ref,
    spectral_apply_fused_ref,
    spectral_apply_ref,
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


def _check_operands(xf, w, add):
    """Raise on what the kernel does not take: mixed devices, dtypes other
    than complex64, non-contiguous weights or ``add`` (``xf`` may have any
    strides), a mis-shaped ``add``."""
    tensors = [("xf", xf), ("w", w)] + ([("add", add)] if add is not None else [])
    devices = {t.device for _, t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for name, t in tensors:
        if t.dtype != torch.complex64:
            raise ValueError(f"{name} dtype {t.dtype} != torch.complex64")
        if device.type == "cuda" and name != "xf" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if add is not None:
        want = (xf.shape[0], w.shape[1]) + tuple(w.shape[2:])
        if tuple(add.shape) != want:
            raise ValueError(f"add shape {tuple(add.shape)} != {want}")
    return device


def spectral_fused_cuda(xf, w, trunc, t_out=None, add=None) -> torch.Tensor:
    """Launch the CUDA kernel on PyTorch's current stream (no synchronise).

    Operands are validated by the caller. ``spectral_fused_cuda.launches``
    counts the launches, so a run can show its main path went through the
    kernel.
    """
    b, ci, e1, e2, e3 = xf.shape[:5]
    co, k1, k2, k3, kt = w.shape[1:]
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
            b, ci, co, e1, e2, e3, k1, k2, k3, kt, tout, *n, strides, stream,
        )
    if err:
        raise RuntimeError(
            "spectral_fused kernel launch failed: "
            + lib.spectral_fused_error_string(err).decode()
        )
    spectral_fused_cuda.launches += 1
    return y


spectral_fused_cuda.launches = 0


def _fused(xf, w, trunc, t_out, add):
    trunc = tuple(trunc)
    _validate_fused(xf.shape, w.shape, trunc, t_out)
    if _check_operands(xf, w, add).type == "cuda":
        return spectral_fused_cuda(xf, w, trunc, t_out, add)
    y = spectral_apply_fused_ref(xf, w, trunc, t_out)
    if add is not None:
        y = y + pad_kept_ref(add, trunc, t_out)
    return y


def spectral_apply_fused(xf, w, trunc, *, t_out: int | None = None) -> torch.Tensor:
    """Fused S^T (W ·) S: truncate + complex channel mix + zero-pad.

    xf: [b, ci, E1, E2, E3, T] complex64 spectrum. w: [ci, co, K1, K2, K3,
    KT] complex64 kept-mode weights. ``trunc[d]`` = full size N of spatial
    dim d (truncate/pad inside the op) or None if pre-truncated upstream.
    The trailing rFFT dim keeps bins [:KT] and pads back to ``t_out`` when
    given. Returns [b, co, E1, E2, E3, t_out or KT].
    """
    return _fused(xf, w, trunc, t_out, None)


def spectral_apply_fused_add(
    xf, w, add, trunc, *, t_out: int | None = None
) -> torch.Tensor:
    """The fused op on the dynamic remainder ``xf`` plus a cached kept-mode
    static contribution ``add`` [b, co, K1, K2, K3, KT], summed on the kept
    positions. Padding is linear, so this equals
    pad(mix(trunc(xf))) + pad(add); the kernel does it in one pass."""
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
