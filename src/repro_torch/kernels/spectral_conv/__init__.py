"""Fused spectral convolution: CUDA kernel, its plain version, wrappers."""
from repro_torch.kernels.spectral_conv.ops import (
    spectral_apply_fused,
    spectral_apply_fused_add,
    spectral_fused_cuda,
    spectral_static_contribution,
)
from repro_torch.kernels.spectral_conv.ref import (
    pad_kept_ref,
    spectral_apply_fused_ref,
    spectral_apply_ref,
)

__all__ = [
    "pad_kept_ref",
    "spectral_apply_fused",
    "spectral_apply_fused_add",
    "spectral_apply_fused_ref",
    "spectral_apply_ref",
    "spectral_fused_cuda",
    "spectral_static_contribution",
]
