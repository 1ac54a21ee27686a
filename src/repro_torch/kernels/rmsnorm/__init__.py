"""Fused RMSNorm: the CUDA kernel, its plain version and the wrapper."""
from repro_torch.kernels.rmsnorm.ops import LIBRARY, rmsnorm, rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

__all__ = ["LIBRARY", "rmsnorm", "rmsnorm_cuda", "rmsnorm_ref"]
