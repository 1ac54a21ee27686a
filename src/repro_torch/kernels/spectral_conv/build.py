"""Build the spectral kernel library from the repository's CUDA sources.

The library is compiled at first use, on the machine with the card, by
``torch.utils.cpp_extension.load`` into ``build/torch_ext/`` at the
repository root (listed in ``.gitignore``), and loaded with ``ctypes``. The
source has a plain C interface and includes no PyTorch header, so ``nvcc``
takes seconds rather than minutes; ``load`` caches by content, so a second
process reuses the build. A failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = (os.path.join(_HERE, "csrc", "spectral_fused.cu"),)
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
    lib.spectral_fused_launch.argtypes = (
        [_c_ptr] * 4 + [_c_int] * 14 + [ctypes.POINTER(ctypes.c_longlong), _c_ptr]
    )
    lib.spectral_fused_launch.restype = _c_int
    lib.spectral_fused_error_string.argtypes = [_c_int]
    lib.spectral_fused_error_string.restype = ctypes.c_char_p
    return lib
