"""Build the port's CUDA kernel libraries from the repository's sources.

Each kernel family is one shared library (``KernelLibrary``) of ``.cu``
sources with a plain C interface: they include no PyTorch header, so
``nvcc`` takes seconds, and the wrappers load them with ``ctypes``. A
library is compiled at first use, on the machine with the card, by
``torch.utils.cpp_extension.load`` into its own directory under
``build/torch_ext/`` at the repository root (listed in ``.gitignore``);
``load`` compiles a library's sources in parallel through ninja and
caches by content, so another process reuses the build. ``build`` loads
several libraries at once, one thread each. A failed build raises with the
compiler's output. Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence, Tuple

BUILD_DIR = os.path.abspath(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..", "build", "torch_ext")
)
CUDA_CFLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    name: str
    sources: Tuple[str, ...]

    @property
    def build_directory(self) -> str:
        # one directory per library: ninja's build file is named per directory
        return os.path.join(BUILD_DIR, self.name)


def _compile(library: KernelLibrary) -> str:
    from torch.utils import cpp_extension

    if cpp_extension.CUDA_HOME is None:
        raise RuntimeError("cannot build the CUDA kernels: no CUDA toolkit with nvcc was "
                           "found (set CUDA_HOME)")
    os.makedirs(library.build_directory, exist_ok=True)
    return cpp_extension.load(
        name=library.name,
        sources=list(library.sources),
        build_directory=library.build_directory,
        extra_cuda_cflags=CUDA_CFLAGS,
        is_python_module=False,
        verbose=False,
    )


def build(libraries: Sequence[KernelLibrary]) -> list:
    """Compile (once per source content) every library, all at once;
    returns their paths."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return list(pool.map(_compile, libraries))


def build_variants(source: str, variants: dict, prefix: str) -> dict:
    """Build textual variants of one source, each a library of its own, all
    at once; returns their paths by variant name. ``variants`` maps a name
    to (old, new) substitutions; one whose text is missing raises. The A/B
    tools under ``launch/`` time such variants; they are not kernels of the
    port."""
    with open(source) as f:
        text = f.read()
    libraries = []
    for i, subs in enumerate(variants.values()):
        variant = text
        for old, new in subs:
            if old not in variant:
                raise ValueError(f"variant substitution not found in {source}: {old!r}")
            variant = variant.replace(old, new)
        src_dir = os.path.join(BUILD_DIR, f"{prefix}_src", str(i))
        os.makedirs(src_dir, exist_ok=True)
        path = os.path.join(src_dir, os.path.basename(source))
        with open(path, "w") as f:
            f.write(variant)
        libraries.append(KernelLibrary(f"{prefix}_{i}", (path,)))
    return dict(zip(variants, build(libraries)))


def load(library: KernelLibrary) -> ctypes.CDLL:
    """The library, built first if need be, loaded (each family's
    ``load_library`` keeps the handle)."""
    return ctypes.CDLL(build([library])[0])
