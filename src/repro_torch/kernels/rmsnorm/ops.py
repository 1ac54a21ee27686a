"""Public wrapper of the fused RMSNorm.

Port of ``repro.kernels.rmsnorm.ops``. The path is chosen by where the
tensor lies, and by nothing else: a CUDA tensor goes to the hand-written
kernel (``csrc/rmsnorm.cu``), a CPU tensor — which only a caller that asked
for the CPU has — to the plain version in ``ref``. A failed build or launch
raises; there is no fallback. Unlike the TPU wrapper, nothing is padded:
the kernel takes any number of rows and any width.
"""
from __future__ import annotations

import ctypes
import functools
import os

import torch

from repro_torch.kernels.build import KernelLibrary, load
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

LIBRARY = KernelLibrary("repro_torch_rmsnorm", (
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "rmsnorm.cu"),
))
_TYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = load(LIBRARY)
    lib.rmsnorm_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on PyTorch's current stream (no synchronise) on a
    validated contiguous x [..., d] and f32 w [d]. Counts its launches on
    ``rmsnorm_cuda.launches``."""
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, d, float(eps),
                                 _TYPES[x.dtype], stream)
    if err:
        raise RuntimeError("rmsnorm kernel launch failed: "
                           + lib.rmsnorm_error_string(err).decode())
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d] bf16 or f32; w: [d]. ``x * rsqrt(mean(x^2) + eps) * w``
    with f32 statistics, in x's dtype."""
    if x.dim() < 1 or tuple(w.shape) != (x.shape[-1],):
        raise ValueError(f"w shape {tuple(w.shape)} != ({x.shape[-1] if x.dim() else '?'},)")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _TYPES:
        raise ValueError(f"x dtype {x.dtype} is not float32 or bfloat16")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous for the CUDA kernel")
    if x.numel() == 0:
        return torch.empty_like(x)
    return rmsnorm_cuda(x, w.float().contiguous(), eps)
