"""Fused spectral convolution: CUDA kernels, their plain versions, wrappers."""
from repro_torch.kernels.spectral_conv.ops import (
    spectral_apply_fused,
    spectral_apply_fused_add,
    spectral_fused_cuda,
    spectral_fused_dw,
    spectral_fused_dw_cuda,
    spectral_fused_dx,
    spectral_static_contribution,
)
from repro_torch.kernels.spectral_conv.ref import (
    gather_kept_ref,
    pad_kept_ref,
    spectral_apply_fused_ref,
    spectral_apply_ref,
    spectral_fused_dw_ref,
)

__all__ = [
    "gather_kept_ref",
    "pad_kept_ref",
    "spectral_apply_fused",
    "spectral_apply_fused_add",
    "spectral_apply_fused_ref",
    "spectral_apply_ref",
    "spectral_fused_cuda",
    "spectral_fused_dw",
    "spectral_fused_dw_cuda",
    "spectral_fused_dw_ref",
    "spectral_fused_dx",
    "spectral_static_contribution",
]
