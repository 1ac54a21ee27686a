"""Flash attention (forward): the CUDA kernel, its plain version and the wrapper."""
from repro_torch.kernels.flash_attention.ops import (
    KERNEL_HEAD_DIMS,
    LIBRARY,
    flash_attention,
    flash_attention_cuda,
    kernel_head_dim,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["KERNEL_HEAD_DIMS", "LIBRARY", "flash_attention", "flash_attention_cuda",
           "flash_attention_ref", "kernel_head_dim"]
