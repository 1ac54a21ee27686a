"""Plain PyTorch versions of the spectral convolution (per-mode channel mix).

Y[b, co, K] = sum_ci X[b, ci, K] * W[ci, co, K]   (complex64), where K
ranges over the kept Fourier modes. Port of ``repro.kernels.spectral_conv.ref``.
The CPU path of ``ops`` runs these; on the card they are the yardstick the
CUDA kernel is held against.
"""
from __future__ import annotations

import torch

from repro_torch.core.dfft import pad_full, pad_rfft, truncate_full


def spectral_apply_ref(xf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """xf: [b, ci, *modes] complex; w: [ci, co, *modes] complex.

    Returns [b, co, *modes]: element-wise over the mode dims, contracted
    over ci.
    """
    n_modes = xf.ndim - 2
    mode_axes = "".join(chr(ord("s") + i) for i in range(n_modes))
    return torch.einsum(f"bi{mode_axes},io{mode_axes}->bo{mode_axes}", xf, w)


def pad_kept_ref(yk: torch.Tensor, trunc, t_out: int | None = None) -> torch.Tensor:
    """Zero-pad a kept-mode tensor [b, co, K1, K2, K3, KT] back to the fused
    output layout: full size ``trunc[d]`` on each spatial dim where trunc[d]
    is not None, and rFFT tail-pad the trailing dim to ``t_out`` when given.
    """
    for d, n in enumerate(tuple(trunc)):
        if n is not None:
            yk = pad_full(yk, 2 + d, n)
    if t_out is not None and t_out != yk.shape[-1]:
        yk = pad_rfft(yk, yk.ndim - 1, t_out)
    return yk


def spectral_apply_fused_ref(
    xf: torch.Tensor,
    w: torch.Tensor,
    trunc,
    t_out: int | None = None,
) -> torch.Tensor:
    """Unfused truncate -> mix -> pad, the plain version of the fused op.

    xf: [b, ci, E1, E2, E3, T] complex spectrum; w: [ci, co, K1, K2, K3, KT]
    complex kept-mode weights. ``trunc[d]`` is the full size N of spatial
    dim d to truncate from / pad back to, or None if the dim arrives
    pre-truncated (E_d == K_d). The trailing dim keeps bins [:KT] and pads
    the tail back to ``t_out`` (or stays at KT).
    """
    trunc = tuple(trunc)
    kt = w.shape[-1]
    for d, n in enumerate(trunc):
        if n is not None:
            xf = truncate_full(xf, 2 + d, w.shape[2 + d] // 2)
    xf = xf.narrow(-1, 0, kt)
    return pad_kept_ref(spectral_apply_ref(xf, w), trunc, t_out)


def gather_kept_ref(xf: torch.Tensor, trunc, kept) -> torch.Tensor:
    """S: the kept positions of a (partly) full spectrum [b, c, E1, E2, E3,
    T] as [b, c, K1, K2, K3, KT]: ``[:m]`` and ``[N-m:]`` on a truncated
    dim (``trunc[d]`` = N), the identity on a pre-truncated one (None), and
    the first KT bins of the trailing dim. The adjoint of ``pad_kept_ref``."""
    for d, n in enumerate(tuple(trunc)):
        if n is not None:
            xf = truncate_full(xf, 2 + d, kept[d] // 2)
    return xf.narrow(-1, 0, kept[3])


def spectral_fused_dw_ref(
    xf: torch.Tensor, g: torch.Tensor, trunc, kept
) -> torch.Tensor:
    """Weight cotangent of the fused op in torch's convention, the plain
    version of ``csrc/spectral_fused_dw.cu``:

        w_bar[ci, co, k] = sum_b conj(S(x))[b, ci, k] * S(g)[b, co, k]

    xf: [b, ci, E1, E2, E3, Tx] the spectrum the forward consumed; g: [b,
    co, E1, E2, E3, Tg] the cotangent of its output; ``kept`` = (K1, K2,
    K3, KT). JAX's ``spectral_fused_dw`` takes the plain transpose (no
    conjugation) on JAX's cotangent, which is the conjugate of torch's
    ``.grad``: fed ``conj(g)``, it returns the conjugate of this.
    """
    kept = tuple(int(k) for k in kept)
    if xf.shape[5] < kept[3] or g.shape[5] < kept[3]:
        raise ValueError(f"time bins {xf.shape[5]}/{g.shape[5]} < kt={kept[3]}")
    sx = gather_kept_ref(xf, trunc, kept)
    sg = gather_kept_ref(g, trunc, kept)
    return torch.einsum("bistuv,bostuv->iostuv", sx.conj(), sg)
