"""Build the spectral kernel library from the repository's CUDA sources.

Two kernels, one library: the fused truncate + mix + pad
(``csrc/spectral_fused.cu``, forward and the backward's dx) and its
weight cotangent (``csrc/spectral_fused_dw.cu``). The library is compiled
at first use, on the machine with the card, by
``torch.utils.cpp_extension.load`` into ``build/torch_ext/`` at the
repository root (listed in ``.gitignore``), and loaded with ``ctypes``. The
sources have a plain C interface and include no PyTorch header, so ``nvcc``
takes seconds rather than minutes (``load`` compiles the sources in
parallel through ninja); ``load`` caches by content, so a second
process reuses the build. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (
    os.path.join(_HERE, "csrc", "spectral_fused.cu"),
    os.path.join(_HERE, "csrc", "spectral_fused_dw.cu"),
)
BUILD_DIR = os.path.abspath(
    os.path.join(_HERE, "..", "..", "..", "..", "build", "torch_ext")
)
LIB_NAME = "repro_torch_spectral_conv"
CUDA_CFLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Compile (once per source content) and load the kernel library."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    path = load(
        name=LIB_NAME,
        sources=list(SOURCES),
        build_directory=BUILD_DIR,
        extra_cuda_cflags=CUDA_CFLAGS,
        is_python_module=False,
        verbose=False,
    )
    lib = ctypes.CDLL(path)
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
