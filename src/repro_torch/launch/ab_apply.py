"""A/B of flattened-K mix kernel variants on the card, in one process.

    PYTHONPATH=src python -m repro_torch.launch.ab_apply [--first-version DIR]

Each variant is ``csrc/spectral_apply.cu`` with textual substitutions,
built as a library of its own under ``build/torch_ext/`` and launched
through the same C interface as the wrapper, at the shapes phase 2b of
``chip_smoke.py`` times: the Sleipner FNO's full kept-mode width (ci = co =
40, modes (48, 32, 16, 10), K = 245,760) at b = 2 and b = 1, and the 1-D
P = 4 shard (modes (48, 8, 16, 10), K = 61,440) at b = 2; the forward and
dx (conj(W^T) through swapped strides). It prints, per shape, each
variant's median device time from one ``torch.profiler`` trace (10 calls
each, in turns: A B ... then ... B A) with its max|d| against the plain
version, beside the bytes bound. With ``--first-version DIR`` (the root of a checkout of an earlier
tree) that tree's ``spectral_apply.cu`` is built and timed too, and the
registers ptxas gives each kernel are printed with the waves of the
first version's grid (one 128-thread block per 128 modes and 8 output
channels) that fit the card at once. The variants change the committed
constants; they are not kernels of the port. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess

import numpy as np
import torch

from repro_torch.common.constants import HBM_BANDWIDTH as HBM_BYTES_PER_S
from repro_torch.kernels.build import CUDA_CFLAGS, KernelLibrary, build, build_variants
from repro_torch.kernels.spectral_conv.build import LIBRARY
from repro_torch.kernels.spectral_conv.ref import spectral_apply_ref
from repro_torch.launch.ab_rmsnorm import device_ms_in_turns

SOURCE = next(s for s in LIBRARY.sources if s.endswith("spectral_apply.cu"))
VARIANTS = {
    "as committed": [],
    "8-byte copies": [("const bool v16 = K % 2 == 0", "const bool v16 = false && K % 2 == 0")],
    "16-byte copies through L1": [('"cp.async.cg.shared.global [%0], [%1], 16;\\n"',
                                   '"cp.async.ca.shared.global [%0], [%1], 16;\\n"')],
    "3 stages": [("constexpr int kStages = 4;", "constexpr int kStages = 3;")],
    "6 stages, 1 block an SM": [("constexpr int kStages = 4;", "constexpr int kStages = 6;"),
                                ("constexpr int kMinBlocksPerSm = 2;",
                                 "constexpr int kMinBlocksPerSm = 1;")],
    "runs on 512-byte lines": [("constexpr int kRunAlign = 8;", "constexpr int kRunAlign = 32;")],
    "runs on any pair": [("constexpr int kRunAlign = 8;", "constexpr int kRunAlign = 1;")],
}
CI = CO = 40
FULL = (48, 32, 16, 10)
SHAPES = [("full b=2", 2, FULL), ("full b=1", 1, FULL), ("shard P=4 b=2", 2, (48, 8, 16, 10))]
FIRST_THREADS, FIRST_CO_TILE = 128, 8  # the first version's block and channel tile


def _bind(lib):
    lib.spectral_apply_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 5
        + [ctypes.c_int, ctypes.c_void_p])
    lib.spectral_apply_launch.restype = ctypes.c_int
    return lib


def launch(lib, x, w, conj_transpose=False) -> torch.Tensor:
    b, k = x.shape[0], x[0, 0].numel()
    if conj_transpose:
        co, ci = w.shape[:2]
        w_in, w_out = w.stride(1), w.stride(0)
    else:
        ci, co = w.shape[:2]
        w_in, w_out = w.stride(0), w.stride(1)
    y = torch.empty((b, co) + tuple(x.shape[2:]), dtype=torch.complex64, device=x.device)
    err = lib.spectral_apply_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, ci, co, k,
                                    x.stride(0), x.stride(1), w_in, w_out, int(conj_transpose),
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return y


def registers(src: str) -> dict:
    """Registers a thread of each kernel in ``src``, from ``nvcc -Xptxas -v``."""
    from torch.utils import cpp_extension

    nvcc = os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc")
    out = subprocess.run([nvcc, *CUDA_CFLAGS, "-std=c++17", "-Xptxas", "-v", "-c", src,
                          "-o", os.devnull], capture_output=True, text=True, check=True)
    regs, name = {}, None
    for line in (out.stdout + out.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def first_version_waves(regs: int, sms: int, k: int) -> float:
    """Waves of the first version's grid at K modes: blocks over what the
    card holds at once (registers, threads and 32 blocks an SM)."""
    per_sm = min(65536 // (regs * FIRST_THREADS), 2048 // FIRST_THREADS, 32)
    blocks = -(-k // FIRST_THREADS) * -(-CO // FIRST_CO_TILE)
    return blocks / (per_sm * sms)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--first-version", default=None,
                        help="root of a checkout whose spectral_apply.cu is timed beside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_apply needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = {name: _bind(ctypes.CDLL(path))
            for name, path in build_variants(SOURCE, VARIANTS, "ab_apply").items()}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if args.first_version:
        first_src = os.path.join(args.first_version, "src", "repro_torch", "kernels",
                                 "spectral_conv", "csrc", "spectral_apply.cu")
        libs["first version"] = _bind(ctypes.CDLL(
            build([KernelLibrary("ab_apply_first", (first_src,))])[0]))
        first_regs = registers(first_src)
        print(f"[ab_apply] registers a thread (ptxas): first version {first_regs}; committed "
              f"{registers(SOURCE)}", flush=True)
        for tag, b, modes in SHAPES:
            k = int(np.prod(modes))
            waves = {name.split("ILi")[-1][:1]: round(first_version_waves(r, sms, k), 2)
                     for name, r in first_regs.items()}
            print(f"[ab_apply] first version at {tag}, K={k}: waves of its grid by batch "
                  f"template {waves} on {sms} SMs", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rand(shape):
        return torch.randn(shape, dtype=torch.complex64, device="cuda", generator=gen)

    w_full = rand((CI, CO) + FULL)
    for tag, b, modes in SHAPES:
        k = int(np.prod(modes))
        w = w_full if modes == FULL else rand((CI, CO) + modes)
        x, g = rand((b, CI) + modes), rand((b, CO) + modes)
        bound = 8 * k * (b * CI + CI * CO + b * CO) / HBM_BYTES_PER_S * 1e3
        for op, inp, conj in (("forward", x, False), ("dx", g, True)):
            ref = spectral_apply_ref(inp, w.transpose(0, 1).conj() if conj else w)
            scale = float(ref.abs().max())
            errs = {name: float((launch(lib, inp, w, conj) - ref).abs().max()) / scale
                    for name, lib in libs.items()}
            del ref
            ms = device_ms_in_turns({name: lambda lib=lib: launch(lib, inp, w, conj)
                                     for name, lib in libs.items()}, n=10, tag="ab_apply")
            runs = [f"{name} {t:.3f} ms ({bound / t:.0%}; max|d| {errs[name]:.1e} of max|ref|)"
                    for name, t in ms.items()]
            print(f"[ab_apply] {tag} {op}, K={k}, bound {bound:.3f} ms (bytes), device time: "
                  + "; ".join(runs) + f"; {gpu}", flush=True)
        del x, g, w
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
