"""The spectral kernel library: its sources and its C interface.

Two kernels, one library: the fused truncate + mix + pad
(``csrc/spectral_fused.cu``, forward and the backward's dx) and its
weight cotangent (``csrc/spectral_fused_dw.cu``). ``kernels.build``
compiles it at first use; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import os

from repro_torch.kernels.build import KernelLibrary, load

_HERE = os.path.dirname(os.path.abspath(__file__))
LIBRARY = KernelLibrary("repro_torch_spectral_conv", (
    os.path.join(_HERE, "csrc", "spectral_fused.cu"),
    os.path.join(_HERE, "csrc", "spectral_fused_dw.cu"),
))

_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (once per source content) and load the kernel library."""
    lib = load(LIBRARY)
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.spectral_fused_launch.argtypes = (
        [_c_ptr] * 4 + [_c_int] * 14
        + [strides, ctypes.c_longlong, ctypes.c_longlong, _c_int, _c_ptr]
    )
    lib.spectral_fused_launch.restype = _c_int
    lib.spectral_fused_dw_launch.argtypes = (
        [_c_ptr] * 3 + [_c_int] * 10 + [strides, strides, _c_ptr]
    )
    lib.spectral_fused_dw_launch.restype = _c_int
    lib.spectral_fused_error_string.argtypes = [_c_int]
    lib.spectral_fused_error_string.restype = ctypes.c_char_p
    return lib
