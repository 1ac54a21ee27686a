"""A/B of weight-cotangent kernel variants on the card, in one process.

    PYTHONPATH=src python -m repro_torch.launch.ab_dw

Each variant is ``csrc/spectral_fused_dw.cu`` with textual substitutions,
built as a library of its own under ``build/torch_ext/`` and launched
through the same C interface as the wrapper at the FNO training block
(micro-batch 1, ci = co = 40, E = (64, 32, 32), T = 45, K = (48, 32, 16,
10)): once with x and g as the FFTs hand them over (x t-outermost from
rfftn, g from the irfftn backward) and once contiguous. It prints, per
layout, each variant's median time from CUDA events in turns (A B ... then
... B A) with its max|d| against the plain version, and the time of
``zero_()`` on a w-sized tensor: the store floor. The variants change the
committed constants (threads, co rows a warp computes together, channel
tile, stage budget), or time what the gathers cost: "no gathers" drops
them (its results are wrong), "gathers through registers" loads in place
of ``cp.async``, "x gathered along kt" ignores x's stride-1 dimension.
They are not kernels of the port. Needs a CUDA card.
"""
from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from repro_torch.kernels.build import build_variants
from repro_torch.kernels.spectral_conv.build import LIBRARY
from repro_torch.kernels.spectral_conv.ref import spectral_fused_dw_ref

SOURCE = next(s for s in LIBRARY.sources if s.endswith("spectral_fused_dw.cu"))
VARIANTS = {
    "as committed": [],
    "no gathers": [('asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\\n" ::"r"(s), "l"(src)\n'
                    '               : "memory");', "")],
    "gathers through registers": [
        ('asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\\n" ::"r"(s), "l"(src)\n'
         '               : "memory");', "(void)s;\n  *dst = __ldg(src);")],
    "x gathered along kt": [("d.x_kt_fast = magnitude(xs[5]) <= magnitude(xs[4]);",
                             "d.x_kt_fast = 1;")],
    "1024 threads": [("constexpr int kThreads = 512;", "constexpr int kThreads = 1024;")],
    "2 co rows a warp": [("constexpr int kRows = 4;", "constexpr int kRows = 2;")],
    "8 co rows a warp": [("constexpr int kRows = 4;", "constexpr int kRows = 8;")],
    "channel tile 20": [("constexpr int kChannelTile = 40;", "constexpr int kChannelTile = 20;")],
    "stage 50 KB, 2 blocks an SM": [
        ("constexpr int kStageBytes = 100 * 1024;", "constexpr int kStageBytes = 50 * 1024;"),
        ("__launch_bounds__(kThreads, 1)", "__launch_bounds__(kThreads, 2)")],
}
# (b, ci, co, E, T, K): the training block of the one-card FNO
SHAPE = (1, 40, 40, (64, 32, 32), 45, (48, 32, 16, 10))


def load_variants() -> dict:
    """Every variant, built at once and loaded, by name."""
    libs = {}
    strides = ctypes.POINTER(ctypes.c_longlong)
    for name, path in build_variants(SOURCE, VARIANTS, "ab_dw").items():
        lib = ctypes.CDLL(path)
        lib.spectral_fused_dw_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [strides, strides, ctypes.c_void_p])
        libs[name] = lib
    return libs


def launch(lib, xf, g, trunc, kept) -> torch.Tensor:
    b, ci = xf.shape[:2]
    w = torch.empty((ci, g.shape[1]) + tuple(kept), dtype=torch.complex64, device=xf.device)
    xs = (ctypes.c_longlong * 6)(*xf.stride())
    gs = (ctypes.c_longlong * 6)(*g.stride())
    err = lib.spectral_fused_dw_launch(xf.data_ptr(), g.data_ptr(), w.data_ptr(), b, ci,
                                       g.shape[1], *kept, *trunc, xs, gs,
                                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    return w


def median_ms(fn, iters: int = 10) -> float:
    """Median of ``iters`` single calls, each between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def training_operands(gen):
    """x as rfftn returns it and g as the irfftn backward returns it."""
    b, ci, co, ext, t, _ = SHAPE
    nt = 2 * (t - 1)
    xf = torch.fft.rfftn(torch.randn((b, ci) + ext + (nt,), device="cuda", generator=gen),
                         dim=(2, 3, 4, 5))
    yf = torch.zeros((b, co) + ext + (t,), dtype=torch.complex64, device="cuda",
                     requires_grad=True)
    y = torch.fft.irfftn(yf, s=ext + (nt,), dim=(2, 3, 4, 5))
    y.backward(torch.randn(y.shape, device="cuda", generator=gen))
    return xf, yf.grad


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_dw needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = load_variants()
    _, _, _, ext, _, kept = SHAPE
    xf, g = training_operands(torch.Generator(device="cuda").manual_seed(0))
    for layout in ("FFT layouts", "contiguous"):
        if layout == "contiguous":
            xf, g = xf.contiguous(), g.contiguous()
        ref = spectral_fused_dw_ref(xf, g, ext, kept)
        zero_ms = median_ms(lambda: torch.empty_like(ref).zero_())
        runs = []
        for name in list(libs) + list(libs)[::-1]:
            err = float((launch(libs[name], xf, g, ext, kept) - ref).abs().max())
            ms = median_ms(lambda: launch(libs[name], xf, g, ext, kept))
            runs.append(f"{name} {ms:.3f} ms (max|d| {err:.2e})")
        print(f"[ab_dw] training block, {layout} (x strides {xf.stride()}, g strides "
              f"{g.stride()}; max|ref| {float(ref.abs().max()):.3e}): zero_ of w {zero_ms:.3f} ms; "
              + "; ".join(runs) + f"; {gpu}", flush=True)
        del ref


if __name__ == "__main__":
    main()
