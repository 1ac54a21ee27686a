#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, each failing hard:
  1. build the three CUDA kernel libraries (spectral, with its four
     kernels; RMSNorm; flash attention) from the repository's sources, all
     three at once, and beside them compile the sources redesigned for the
     H100 (``REPORTED_SOURCES``) once more with ``-Xptxas -v`` to print each
     kernel's registers, shared memory and spills;
  2. hold the fused spectral kernel against its plain PyTorch version
     (``spectral_apply_fused_ref`` + ``pad_kept_ref``) over the trunc
     patterns, t tails, ``add`` and the full-width serving block shape,
     and time both with CUDA events; then the weight-cotangent kernel
     against ``spectral_fused_dw_ref`` over the trunc patterns, t tails
     and the layouts that rfftn and the irfftn backward hand it, and the
     fused op's autograd backward (dx on the fused kernel, dW on the
     cotangent kernel) against plain autograd; both backward kernels are
     timed at the training block shape;
 2b. the flattened-K op ``spectral_apply``: its mix kernel (forward and
     dx on conj(W^T)) and weight-cotangent kernel against
     ``spectral_apply_ref`` / ``spectral_dw_ref`` over 1-4 mode dims,
     ragged K, ci != co, b = 1-6 and permuted batch/channel strides; its
     autograd backward against plain autograd; the mix kernel against the
     fused kernel on pre-truncated modes; one forward + backward through
     the op at the Sleipner FNO's full kept-mode width (ci = co = 40,
     modes (48,32,16,10), b = 2) with exact launch counts; both kernels
     timed there at b = 2 and b = 1 and at the 1-D model-parallel shard
     (48,8,16,10), against their bound, the plain version (one
     ``torch.einsum``, also the library call) and ``torch.bmm`` on the
     K-leading layout;
  3. serve the Sleipner FNO (width 40, modes (24,16,8,10), 4 blocks) on
     grid (128,64,32,88) through ``FNORunner`` and the ``Scheduler``,
     checking every output against the plain unfused forward;
  4. the same size as an ensemble (2 input channels, 1 static geomodel)
     through the deep-split cache: hit-rate > 0, cold == warm bitwise,
     verified likewise;
  5. the serving CLI on a small checkpoint written by the port, with
     ``--verify``, as a subprocess;
  6. train the same model at full width on grid (64,32,32,88): every
     leaf's gradient through the fused path against the unfused forward's,
     then 4 steps of ``make_train_step`` (batch 2 as 2 micro-batches,
     remat on) fed by ``ShardedDatasetLoader``;
  7. the training CLI on the card with an injected fault (restored from
     its checkpoint), then the serving CLI with ``--verify`` on the
     checkpoint it wrote;
  8. hold the RMSNorm and flash-attention kernels against their plain
     versions (``rmsnorm_ref``, ``flash_attention_ref``) over bf16 and f32,
     ragged rows and tails, MHA/GQA/MQA, sq < sk, non-causal, head dims
     16-256 and the serving path's shapes in bf16 and f32 (gemma-7b,
     chatglm3-6b and minitron-8b prefills, prefill and decode norms), with
     bf16 held to one rounding of the output, and time each
     against its bound, its plain version and one PyTorch call
     (``F.rms_norm``, ``F.scaled_dot_product_attention``) as a yardstick;
  9. serve gemma-7b at full width (28 layers, d_model 3072, random
     weights) through ``Engine``: 8 requests of 200-1000 prompt tokens on 4
     slots, 16 tokens each; then, for 2 of the prompts, the prefill's
     last-token logits and the first decode step's logits through the
     kernels against the same through the plain versions;
 10. the LM serving CLI on the card, as a subprocess.

One forward + backward through ``spectral_apply`` must launch its mix
kernel twice (forward, dx), its weight-cotangent kernel once, and no other
kernel. Each served run must launch the fused kernel exactly once per FNO block
per forward; each training step, per micro-batch and block, three times
(forward, remat recompute, dx) and the cotangent kernel once. Each LM
prefill must launch flash attention once per layer, and each LM forward
(prefill or decode step) the RMSNorm kernel 2 L + 1 times.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as the last line ``{"ok": true, "device": {...}}``. Exits non-zero
without a result when there is no CUDA device.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and float32
# rate outside the tensor cores. Bounds are computed against these.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12  # dense tensor-core rate
TOL_REL, TOL_ABS = 1e-4, 1e-6
# LM kernels vs their plain versions, elementwise; both compute in f32 and
# cast once. f32: |d| <= 1e-5 + 1e-5 |ref| (sums in another order). bf16:
# one rounding of the output apart, |d| <= 2^-7 |ref|, plus 1e-3 max|ref|
# for values near zero, whose f32 sums carry the error of the larger terms.
LM_F32_TOL = 1e-5
LM_BF16_REL, LM_BF16_ABS_OF_MAX = 2.0 ** -7, 1e-3
# full-width served logits through the kernels vs through the plain
# versions: 28 layers of bf16 activations, where one rounding flip of an
# activation propagates through every later layer
LM_LOGIT_GATE = 3e-2

KERNEL_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_fused.cu"
KERNEL_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:217"
DW_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_fused_dw.cu"
DW_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:307"
RMSNORM_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
RMSNORM_REPLACES = "src/repro/kernels/rmsnorm/kernel.py:24"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:82"
FLAT_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_apply.cu"
FLAT_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:101"
FLAT_DW_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_dw.cu"
FLAT_DW_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:140"
# sources whose ptxas report (registers, shared memory, spills) phase 1 prints
REPORTED_SOURCES = (FLASH_SOURCE, KERNEL_SOURCE)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median time of ``fn`` in milliseconds from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_loop_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Time per call of ``fn`` in milliseconds, from CUDA events around ``n``
    back-to-back calls (median of ``reps``): for kernels of microseconds,
    where events around a single launch would time the launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of ``fn`` in milliseconds: the union of its
    kernels' spans in a ``torch.profiler`` trace of ``n`` calls, over ``n``.
    For a kernel of microseconds the host's launch overhead outlasts the
    kernel, so CUDA events around back-to-back calls time the host; the
    trace times the device alone. A trace that holds no kernel (the
    profiler can lose its events) is taken again; after two such, the
    time comes from CUDA events around back-to-back calls, an upper bound,
    and the script says so."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_forward import busy_ms

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            trace = os.path.join(d, "trace.json")
            prof.export_chrome_trace(trace)
            busy = busy_ms(trace, ("kernel",))
        if busy > 0:
            return busy / n
    print("[timing] two profiler traces held no kernel; timed by CUDA events instead")
    return cuda_loop_ms(fn, n=n)


def _ptxas_reports(tmp: str) -> list:
    """Start one ``nvcc -Xptxas -v`` compile of each of ``REPORTED_SOURCES``
    (the build's target flags, object into ``tmp``); returns the processes."""
    from torch.utils import cpp_extension

    from repro_torch.kernels.build import CUDA_CFLAGS

    if cpp_extension.CUDA_HOME is None:
        raise SystemExit("[ptxas] no CUDA toolkit with nvcc was found (set CUDA_HOME)")
    nvcc = os.path.join(cpp_extension.CUDA_HOME, "bin", "nvcc")
    return [(src, subprocess.Popen(
        [nvcc, *CUDA_CFLAGS, "-std=c++17", "-Xptxas", "-v", "-c", os.path.join(ROOT, src),
         "-o", os.path.join(tmp, f"{i}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for i, src in enumerate(REPORTED_SOURCES)]


def _ptxas_summary(out: str) -> list:
    """One line per kernel of an ``-Xptxas -v`` report: its name (demangled
    where ``c++filt`` exists), registers, spills and static shared memory
    (dynamic shared memory is set at launch, so ptxas cannot report it)."""
    kernels, name = [], None
    for line in out.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spills = m.group(1), ""
        elif name and "spill" in line:
            spills = line.strip()
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            kernels.append((name, f"{regs.group(1) if regs else '?'} registers; {spills}; "
                                  f"{smem.group(1) if smem else 0} bytes static smem"))
            name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(k for k, _ in kernels),
                               capture_output=True, text=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        names = []
    if len(names) != len(kernels):
        names = [k for k, _ in kernels]
    return [f"{n}: {info}" for n, (_, info) in zip(names, kernels)]


def phase_build() -> float:
    import tempfile

    from repro_torch.kernels import flash_attention, rmsnorm
    from repro_torch.kernels.build import build
    from repro_torch.kernels.spectral_conv import build as spectral_build

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reports = _ptxas_reports(tmp)
        paths = build([spectral_build.LIBRARY, rmsnorm.LIBRARY, flash_attention.LIBRARY])
        spectral_build.load_library()
        rmsnorm.ops.load_library()
        flash_attention.ops.load_library()
        dt = time.perf_counter() - t0
        for src, proc in reports:
            out, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                print(out[-4000:], file=sys.stderr)
                raise SystemExit(f"[ptxas] nvcc -Xptxas -v of {src} exited {proc.returncode}")
            for line in _ptxas_summary(out):
                print(f"[ptxas] {os.path.basename(src)}: {line}")
    print(f"[build] {len(paths)} kernel libraries built/loaded in {dt:.1f}s: "
          + ", ".join(os.path.basename(p) for p in paths))
    return dt


def _bound_ms(nbytes, flops) -> tuple:
    """(bound_ms, bound_by): the larger of the bytes over HBM bandwidth and
    the float32 operations over the FP32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fused_bound_ms(b, ci, co, ext, kept, t_in, t_out, with_add) -> tuple:
    """Bound of the fused op: w once, the kept part of x once, add once,
    the full output once; 8 flops per complex multiply-add."""
    n_kept = int(np.prod(kept))
    out_elems = b * co * ext[0] * ext[1] * ext[2] * t_out
    nbytes = 8 * (ci * co * n_kept + b * ci * n_kept + out_elems
                  + (b * co * n_kept if with_add else 0))
    return _bound_ms(nbytes, 8 * b * ci * co * n_kept)


def _dw_bound_ms(b, ci, co, kept) -> tuple:
    """Bound of the weight cotangent: the kept parts of x and g once, the
    weight gradient once; 8 flops per complex multiply-add."""
    n_kept = int(np.prod(kept))
    nbytes = 8 * (b * ci * n_kept + b * co * n_kept + ci * co * n_kept)
    return _bound_ms(nbytes, 8 * b * ci * co * n_kept)


def phase_kernels(gpu: str) -> dict:
    """CUDA spectral kernel vs its plain version; returns the record of the
    full-width block shape."""
    import torch

    from repro_torch.kernels.spectral_conv import (
        pad_kept_ref, spectral_apply_fused, spectral_apply_fused_add,
        spectral_apply_fused_ref,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    def spectrum(shape):
        """x as the serving path hands it to the kernel: the output of a 4-D
        rfftn, which cuFFT returns with permuted strides."""
        nt = 2 * (shape[-1] - 1)
        real = torch.randn(shape[:-1] + (nt,), device=dev, generator=gen)
        return torch.fft.rfftn(real, dim=(2, 3, 4, 5))

    # (name, b, ci, co, dims [(N or None, K)], t_in, kt, t_out, add, x from rfftn)
    cases = [
        ("trunc NNN, t tail", 2, 3, 5, [(16, 6), (12, 4), (8, 4)], 9, 3, 9, False, False),
        ("trunc NNN, no tail, add, b=5", 5, 4, 3, [(10, 4), (8, 2), (6, 6)], 4, 4, None, True, False),
        ("trunc N--, t tail", 2, 3, 5, [(16, 6), (None, 4), (None, 3)], 5, 3, 7, False, False),
        ("trunc N--, add", 1, 6, 2, [(12, 8), (None, 2), (None, 5)], 6, 2, 6, True, False),
        ("trunc N-N, no tail", 3, 4, 4, [(10, 4), (None, 4), (8, 2)], 3, 3, None, False, False),
        ("trunc N-N, t tail, add", 2, 5, 3, [(9, 4), (None, 3), (7, 6)], 5, 4, 8, True, False),
        ("trunc NNN, rfftn layout, add", 2, 3, 4, [(12, 4), (10, 6), (8, 2)], 7, 3, 7, True, True),
        ("serving block", 2, 40, 40, [(128, 48), (64, 32), (32, 16)], 45, 10, 45, False, True),
        ("serving block, add", 2, 40, 40, [(128, 48), (64, 32), (32, 16)], 45, 10, 45, True, True),
    ]
    worst = 0.0
    record = None
    for name, b, ci, co, dims, t_in, kt, t_out, with_add, from_fft in cases:
        trunc = tuple(n for n, _ in dims)
        ext = tuple(k if n is None else n for n, k in dims)
        kept = tuple(k for _, k in dims) + (kt,)
        xf = (spectrum if from_fft else rand)((b, ci) + ext + (t_in,))
        w = rand((ci, co) + kept)
        add = rand((b, co) + kept) if with_add else None
        if add is None:
            got = spectral_apply_fused(xf, w, trunc, t_out=t_out)
        else:
            got = spectral_apply_fused_add(xf, w, add, trunc, t_out=t_out)
        torch.cuda.synchronize()
        ref = spectral_apply_fused_ref(xf, w, trunc, t_out)
        if add is not None:
            ref = ref + pad_kept_ref(add, trunc, t_out)
        if got.shape != ref.shape:
            raise SystemExit(f"[kernel] {name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        gate = TOL_REL * scale + TOL_ABS
        print(f"[kernel] {name}: max|d|={err:.3e} (gate {gate:.3e}, max|ref|={scale:.3e}); "
              f"x strides {xf.stride()}")
        if not err <= gate:
            raise SystemExit(f"[kernel] {name}: kernel disagrees with its plain version")
        worst = max(worst, err / max(scale, 1e-30))
        if name == "serving block":
            ms = cuda_ms(lambda: spectral_apply_fused(xf, w, trunc, t_out=t_out))
            # the same inputs in contiguous layout: what reading cuFFT's
            # permuted spectrum through its strides costs the kernel
            xc = xf.contiguous()
            contiguous_ms = cuda_ms(lambda: spectral_apply_fused(xc, w, trunc, t_out=t_out))
            del xc
            plain_ms = cuda_ms(lambda: spectral_apply_fused_ref(xf, w, trunc, t_out), iters=5)
            bound_ms, bound_by = _fused_bound_ms(b, ci, co, ext, kept, t_in, t_out, False)
            print(
                f"[kernel] serving block: kernel {ms:.3f} ms ({contiguous_ms:.3f} ms on a "
                f"contiguous x), plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); {gpu}"
            )
            record = {
                "name": "spectral_fused",
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": KERNEL_REPLACES,
                "launches": None,
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,
            }
        del xf, w, add, got, ref
        torch.cuda.empty_cache()
    print(f"[kernel] worst relative error over all cases: {worst:.3e}")
    return record


def _irfftn_cotangent(shape, dev, gen):
    """A cotangent g of the fused op's output as the training path hands it
    over: the gradient that the irfftn backward produces for its input."""
    import torch

    nt = 2 * (shape[-1] - 1)
    yf = torch.zeros(shape, dtype=torch.complex64, device=dev, requires_grad=True)
    y = torch.fft.irfftn(yf, s=tuple(shape[2:5]) + (nt,), dim=(2, 3, 4, 5))
    y.backward(torch.randn(y.shape, device=dev, generator=gen))
    return yf.grad


def _gate(tag, got, ref) -> float:
    """Fail unless max|got - ref| <= 1e-4 max|ref| + 1e-6; returns the error."""
    if tuple(got.shape) != tuple(ref.shape):
        raise SystemExit(f"[{tag}] shape {tuple(got.shape)} != {tuple(ref.shape)}")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    gate = TOL_REL * scale + TOL_ABS
    print(f"[{tag}] max|d|={err:.3e} (gate {gate:.3e}, max|ref|={scale:.3e})")
    if not err <= gate:
        raise SystemExit(f"[{tag}] disagrees with its plain version")
    return err


def phase_backward_kernels(gpu: str) -> tuple:
    """The weight-cotangent kernel and the fused op's backward vs their
    plain versions; both backward kernels timed at the training block
    shape. Returns (dx timing record, dW kernel record)."""
    import torch

    from repro_torch.configs.fno_sleipner import CONFIG, ONE_CARD_TRAIN_BATCH, ONE_CARD_TRAIN_ACCUM
    from repro_torch.configs.fno_sleipner import ONE_CARD_TRAIN_GRID
    from repro_torch.kernels.spectral_conv import (
        pad_kept_ref, spectral_apply_fused, spectral_apply_fused_add,
        spectral_apply_fused_ref, spectral_fused_dw, spectral_fused_dw_ref,
        spectral_fused_dx,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    def rand(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    def spectrum(shape):
        nt = 2 * (shape[-1] - 1)
        real = torch.randn(shape[:-1] + (nt,), device=dev, generator=gen)
        return torch.fft.rfftn(real, dim=(2, 3, 4, 5))

    # (name, b, ci, co, dims [(N or None, K)], t_x, t_g, kt, layouts from the FFTs)
    cases = [
        ("dw NNN, t tails", 2, 3, 5, [(16, 6), (12, 4), (8, 4)], 9, 7, 3, False),
        ("dw NNN, FFT layouts", 3, 4, 3, [(12, 4), (10, 6), (8, 2)], 7, 7, 3, True),
        ("dw N--, t tail", 2, 3, 5, [(16, 6), (None, 4), (None, 3)], 5, 3, 3, False),
        ("dw N-N, t tails", 5, 2, 4, [(10, 4), (None, 4), (8, 2)], 4, 6, 3, False),
    ]
    for name, b, ci, co, dims, t_x, t_g, kt, from_fft in cases:
        trunc = tuple(n for n, _ in dims)
        ext = tuple(k if n is None else n for n, k in dims)
        kept = tuple(k for _, k in dims) + (kt,)
        if from_fft:
            xf = spectrum((b, ci) + ext + (t_x,))
            g = _irfftn_cotangent((b, co) + ext + (t_g,), dev, gen)
        else:
            xf, g = rand((b, ci) + ext + (t_x,)), rand((b, co) + ext + (t_g,))
        got = spectral_fused_dw(xf, g, trunc, kept)
        torch.cuda.synchronize()
        _gate(f"kernel {name}", got, spectral_fused_dw_ref(xf, g, trunc, kept))
        print(f"[kernel] {name}: x strides {xf.stride()}, g strides {g.stride()}")

    # the autograd Function vs plain autograd on the same inputs
    for name, dims, t_in, kt, t_out, with_add in (
        ("backward NNN, t tail", [(16, 6), (12, 4), (8, 4)], 9, 3, 9, False),
        ("backward N-N, add", [(10, 4), (None, 4), (8, 2)], 4, 3, 6, True),
    ):
        trunc = tuple(n for n, _ in dims)
        ext = tuple(k if n is None else n for n, k in dims)
        kept = tuple(k for _, k in dims) + (kt,)
        inputs = [spectrum((2, 3) + ext + (t_in,)), rand((3, 4) + kept)]
        if with_add:
            inputs.append(rand((2, 4) + kept))
        a = torch.randn((2, 4) + ext + (t_out,), device=dev, generator=gen)

        def grads(plain):
            leaves = [t.clone().requires_grad_() for t in inputs]
            if plain:
                y = spectral_apply_fused_ref(leaves[0], leaves[1], trunc, t_out)
                if with_add:
                    y = y + pad_kept_ref(leaves[2], trunc, t_out)
            elif with_add:
                y = spectral_apply_fused_add(*leaves, trunc, t_out=t_out)
            else:
                y = spectral_apply_fused(*leaves, trunc, t_out=t_out)
            (y.real * a - y.imag * a).sum().backward()
            return [t.grad for t in leaves]

        for i, (got, ref) in enumerate(zip(grads(False), grads(True))):
            _gate(f"kernel {name}, grad of input {i}", got, ref)

    # the training block: micro-batch of the main path, layouts of its FFTs
    b = ONE_CARD_TRAIN_BATCH // ONE_CARD_TRAIN_ACCUM
    ci = co = CONFIG.width
    ext = ONE_CARD_TRAIN_GRID[:3]
    t_bins = ONE_CARD_TRAIN_GRID[3] // 2 + 1
    kept = CONFIG.mode_shape
    trunc = ext
    xf = spectrum((b, ci) + ext + (t_bins,))
    g = _irfftn_cotangent((b, co) + ext + (t_bins,), dev, gen)
    w = rand((ci, co) + kept)
    print(f"[kernel] training block b={b} ci={ci} co={co} E={ext} T={t_bins} K={kept}: "
          f"x strides {xf.stride()} (rfftn), g strides {g.stride()} (irfftn backward)")
    dw_err = _gate("kernel training block dW", spectral_fused_dw(xf, g, trunc, kept),
                   spectral_fused_dw_ref(xf, g, trunc, kept))
    wt = w.transpose(0, 1).conj()
    dx_err = _gate("kernel training block dx",
                   spectral_fused_dx(g, w, trunc, t_bins),
                   spectral_apply_fused_ref(g, wt, trunc, t_bins))
    torch.cuda.empty_cache()
    dw_ms = cuda_ms(lambda: spectral_fused_dw(xf, g, trunc, kept))
    dw_plain = cuda_ms(lambda: spectral_fused_dw_ref(xf, g, trunc, kept), iters=5)
    dx_ms = cuda_ms(lambda: spectral_fused_dx(g, w, trunc, t_bins))
    dx_plain = cuda_ms(lambda: spectral_apply_fused_ref(g, wt, trunc, t_bins), iters=5)
    dw_bound, dw_by = _dw_bound_ms(b, ci, co, kept)
    dx_bound, dx_by = _fused_bound_ms(b, co, ci, ext, kept, t_bins, t_bins, False)
    print(f"[kernel] training block dW: kernel {dw_ms:.3f} ms, plain {dw_plain:.3f} ms, "
          f"bound {dw_bound:.3f} ms ({dw_by}); {gpu}")
    print(f"[kernel] training block dx (fused kernel on conj(W^T)): kernel {dx_ms:.3f} ms, "
          f"plain {dx_plain:.3f} ms, bound {dx_bound:.3f} ms ({dx_by}); {gpu}")
    del xf, g, w, wt
    torch.cuda.empty_cache()
    dx = {"train_dx_ms": dx_ms, "train_dx_plain_ms": dx_plain, "train_dx_bound_ms": dx_bound,
          "train_dx_max_abs_err": dx_err}
    record = {
        "name": "spectral_fused_dw",
        "route": "cuda",
        "source": DW_SOURCE,
        "replaces": DW_REPLACES,
        "launches": None,
        "max_abs_err": dw_err,
        "ms": dw_ms,
        "plain_ms": dw_plain,
        "bound_ms": dw_bound,
        "bound_by": dw_by,
        "library_ms": None,
    }
    return dx, record


def _flat_bound_ms(b, ci, co, k) -> tuple:
    """Bound of the flattened-K mix (and of its weight cotangent, which
    moves the same bytes): x [b, ci, K] and w [ci, co, K] read once, y [b,
    co, K] written once; 8 flops per complex multiply-add."""
    return _bound_ms(8 * k * (b * ci + ci * co + b * co), 8 * b * ci * co * k)


def _all_launch_counters():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.spectral_conv import (
        spectral_apply_cuda, spectral_dw_cuda, spectral_fused_cuda, spectral_fused_dw_cuda,
    )

    return {"spectral_fused": spectral_fused_cuda, "spectral_fused_dw": spectral_fused_dw_cuda,
            "spectral_apply": spectral_apply_cuda, "spectral_dw": spectral_dw_cuda,
            "rmsnorm": rmsnorm_cuda, "flash_attention": flash_attention_cuda}


def phase_flat_kernels(gpu: str) -> tuple:
    """The flattened-K op ``spectral_apply``: both kernels and its autograd
    backward vs their plain versions, the mix kernel vs the fused kernel on
    pre-truncated modes, one forward + backward through the op at the
    Sleipner FNO's full kept-mode width with exact launch counts, and the
    kernels timed at the full-width and model-parallel shard shapes.
    Returns the two kernels' records."""
    import torch

    from repro_torch.configs.fno_sleipner import CONFIG
    from repro_torch.kernels.spectral_conv import (
        spectral_apply, spectral_apply_cuda, spectral_apply_dw, spectral_apply_dx,
        spectral_apply_fused, spectral_apply_ref, spectral_dw_cuda, spectral_dw_ref,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def rand(shape):
        return torch.randn(shape, dtype=torch.complex64, device=dev, generator=gen)

    def channels_outermost(z):
        return z.transpose(0, 1).contiguous().transpose(0, 1)

    # (name, b, ci, co, modes, channels outermost): 2-4 mode dims, K not a
    # multiple of 32 or 128, ci != co, b = 1-3 and past the batch chunk of 4
    cases = [
        ("2 modes K=133", 1, 3, 5, (7, 19), False),
        ("3 modes K=165 permuted", 2, 9, 10, (3, 5, 11), True),
        ("4 modes K=210", 3, 4, 17, (2, 3, 5, 7), False),
        ("2 modes K=99 b=3 permuted", 3, 11, 9, (3, 33), True),
        ("4 modes K=1000 permuted", 2, 6, 13, (5, 4, 5, 10), True),
        ("1 mode K=300 b=6", 6, 5, 3, (300,), False),
    ]
    for name, b, ci, co, modes, permuted in cases:
        x, w, g = rand((b, ci) + modes), rand((ci, co) + modes), rand((b, co) + modes)
        if permuted:
            x, w, g = channels_outermost(x), channels_outermost(w), channels_outermost(g)
        _gate(f"flat {name} forward", spectral_apply(x, w), spectral_apply_ref(x, w))
        _gate(f"flat {name} dx", spectral_apply_dx(g, w),
              spectral_apply_ref(g, w.transpose(0, 1).conj()))
        _gate(f"flat {name} dW", spectral_apply_dw(x, g), spectral_dw_ref(x, g))
        print(f"[flat] {name}: x strides {x.stride()}, w strides {w.stride()}")

    def grads(op, inputs, a):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        y = op(*leaves)
        (y.real * a - y.imag * a).sum().backward()
        return y.detach(), [t.grad for t in leaves]

    # the autograd Function vs plain autograd, with exact launch counts
    for name, b, ci, co, modes, permuted in cases[1:3]:
        inputs = [rand((b, ci) + modes), rand((ci, co) + modes)]
        if permuted:
            inputs = [channels_outermost(t) for t in inputs]
        a = torch.randn((b, co) + modes, device=dev, generator=gen)
        before = (spectral_apply_cuda.launches, spectral_dw_cuda.launches)
        _, got = grads(spectral_apply, inputs, a)
        torch.cuda.synchronize()
        moved = (spectral_apply_cuda.launches - before[0], spectral_dw_cuda.launches - before[1])
        if moved != (2, 1):
            raise SystemExit(f"[flat] backward {name}: launches {moved}, want (2, 1)")
        for i, (gk, gp) in enumerate(zip(got, grads(spectral_apply_ref, inputs, a)[1])):
            _gate(f"flat backward {name}, grad of input {i}", gk, gp)

    # the Sleipner FNO's full kept-mode width, and its 1-D model-parallel shard
    ci = co = CONFIG.width
    full = tuple(CONFIG.mode_shape)
    shard = (full[0], full[1] // 4, full[2], full[3])
    xs = rand((2, ci) + full)
    w = rand((ci, co) + full)
    w_part = w[:4, :5].contiguous()
    cross = spectral_apply_fused(xs[:1, :4], w_part, (None, None, None))
    _gate("flat vs fused kernel, pre-truncated 4 modes", spectral_apply(xs[:1, :4], w_part), cross)
    cross = spectral_apply_fused(xs, w, (None, None, None))
    _gate("flat vs fused kernel at full width b=2", spectral_apply(xs, w), cross)
    del cross

    # the op's main path: one forward and backward at full width, b=2,
    # every kernel's count set to 0 just before and read just after
    a = torch.randn((2, co) + full, device=dev, generator=gen)
    counters = _all_launch_counters()
    for c in counters.values():
        c.launches = 0
    y, got = grads(spectral_apply, [xs, w], a)
    torch.cuda.synchronize()
    launches = {k: c.launches for k, c in counters.items()}
    want = {k: {"spectral_apply": 2, "spectral_dw": 1}.get(k, 0) for k in counters}
    print(f"[flat] full width b=2, K={int(np.prod(full))}: one forward + backward through "
          f"spectral_apply launched {launches}; {gpu}")
    if launches != want:
        raise SystemExit(f"[flat] the op's forward + backward launched {launches}, want {want}")
    if tuple(y.shape) != (2, co) + full or not bool(torch.isfinite(y).all()):
        raise SystemExit("[flat] full-width output has a wrong shape or non-finite values")
    y_ref, want_grads = grads(spectral_apply_ref, [xs, w], a)
    errs = {"forward": _gate("flat full width b=2 forward", y, y_ref)}
    for tag, gk, gp in zip(("dx", "dW"), got, want_grads):
        errs[tag] = _gate(f"flat full width b=2 {tag} (autograd vs plain autograd)", gk, gp)
    del y, y_ref, got, want_grads, a
    torch.cuda.empty_cache()

    # timings: kernel, plain version (one torch.einsum, also the library
    # call), and torch.bmm on the K-leading layout of the TPU wrapper
    timed = {}
    for tag, b, modes in (("full b=2", 2, full), ("full b=1", 1, full), ("shard P=4 b=2", 2, shard)):
        k = int(np.prod(modes))
        x = xs[:b] if modes == full else rand((b, ci) + modes)
        wt = w if modes == full else rand((ci, co) + modes)
        g = rand((b, co) + modes)
        fwd = cuda_ms(lambda: spectral_apply(x, wt))
        dx = cuda_ms(lambda: spectral_apply_dx(g, wt))
        dw = cuda_ms(lambda: spectral_apply_dw(x, g))
        plain_fwd = cuda_ms(lambda: spectral_apply_ref(x, wt))
        plain_dw = cuda_ms(lambda: spectral_dw_ref(x, g))
        x2 = x.reshape(b, ci, k).permute(2, 0, 1).contiguous()
        w2 = wt.reshape(ci, co, k).permute(2, 0, 1).contiguous()
        g2 = g.reshape(b, co, k).permute(2, 0, 1).contiguous()
        x2h = x2.conj().resolve_conj().transpose(1, 2)
        bmm_fwd = cuda_ms(lambda: torch.bmm(x2, w2))
        bmm_dw = cuda_ms(lambda: torch.bmm(x2h, g2))
        del x2, w2, g2, x2h
        torch.cuda.empty_cache()
        bound, by = _flat_bound_ms(b, ci, co, k)
        timed[tag] = dict(shape=f"x [{b}, {ci}, {', '.join(map(str, modes))}], w [{ci}, {co}, ...], "
                                f"K={k}, complex64",
                          ms=fwd, dx_ms=dx, dw_ms=dw, plain_ms=plain_fwd, dw_plain_ms=plain_dw,
                          bmm_ms=bmm_fwd, dw_bmm_ms=bmm_dw, bound_ms=bound, bound_by=by)
        print(f"[flat] {tag} K={k}: mix kernel {fwd:.3f} ms, dx {dx:.3f} ms, dW kernel {dw:.3f} ms; "
              f"plain (torch.einsum) {plain_fwd:.3f} / dW {plain_dw:.3f} ms; torch.bmm on the "
              f"K-leading layout {bmm_fwd:.3f} / dW {bmm_dw:.3f} ms; bound {bound:.3f} ms ({by}); {gpu}")
        del x, wt, g
    del xs, w
    torch.cuda.empty_cache()

    def record(name, source, replaces, prefix, err, n):
        t = timed["full b=2"]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": err, "ms": t[prefix + "ms"],
            "plain_ms": t[prefix + "plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t[prefix + "plain_ms"],
            "library_call": "torch.einsum, the plain version itself",
            "bmm_ms": t[prefix + "bmm_ms"], "shape": t["shape"],
            "other_shapes": {tag: {key: v[prefix + key] for key in ("ms", "plain_ms", "bmm_ms")}
                             | {"bound_ms": v["bound_ms"], "shape": v["shape"]}
                             for tag, v in timed.items() if tag != "full b=2"},
            "launches_by_path": {"spectral_apply forward + backward": n},
        }

    flat = record("spectral_apply", FLAT_SOURCE, FLAT_REPLACES, "", errs["forward"],
                  launches["spectral_apply"])
    flat["dx_ms"] = {tag: v["dx_ms"] for tag, v in timed.items()}
    flat["dx_max_abs_err"] = errs["dx"]
    flat_dw = record("spectral_dw", FLAT_DW_SOURCE, FLAT_DW_REPLACES, "dw_", errs["dW"],
                     launches["spectral_dw"])
    return flat, flat_dw


def _serving_cfg(in_channels: int = 1):
    import dataclasses

    from repro_torch.configs.fno_sleipner import CONFIG, ONE_CARD_GRID

    return dataclasses.replace(CONFIG, grid=ONE_CARD_GRID, in_channels=in_channels)


def _check_launches(tag: str, launches: int, n_blocks: int, forwards: int, gpu: str) -> int:
    """Every forward of a served run launches the spectral kernel once per
    FNO block; fail otherwise."""
    print(f"[{tag}] spectral_fused launches: {launches} over {forwards} forwards "
          f"x {n_blocks} blocks; {gpu}")
    if forwards == 0 or launches != n_blocks * forwards:
        raise SystemExit(f"[{tag}] expected {n_blocks} x {forwards} spectral kernel "
                         f"launches, counted {launches}")
    return launches


def _report_serving(tag, done, dt, runner):
    import torch

    lat = sorted(r.finished_s - r.submitted_s for r in done)
    n = len(done)
    for r in done:
        for y in r.outputs:
            if y.shape != (runner.cfg.out_channels,) + runner.cfg.grid or not np.isfinite(y).all():
                raise SystemExit(f"[{tag}] rid {r.rid}: bad output shape {y.shape} or non-finite values")
    print(
        f"[{tag}] served {n} scenarios x {len(done[0].outputs)} steps in {dt:.3f}s: "
        f"{n / dt:.3f} scen/s, p50 latency {lat[n // 2] * 1e3:.1f} ms, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )


def _free_cuda():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_serving(gpu: str) -> int:
    """Full-width Sleipner serving through FNORunner + Scheduler; returns the
    spectral kernel's launch count over the served run."""
    import torch

    from repro_torch.configs.fno_sleipner import ONE_CARD_SLOTS
    from repro_torch.core.fno import init_params
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda
    from repro_torch.launch.serve_pde import build_scenarios, check_served, serve, verify
    from repro_torch.serve import FNORunner

    cfg = _serving_cfg()
    print("reduced: grid 256x128x64 -> 128x64x32")
    print(f"[serve] config {cfg}")
    dev = torch.device("cuda")
    _free_cuda()
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    nbytes = sum(t.numel() * t.element_size() for g in params.values() for t in g.values())
    print(f"[serve] weights on the card: {nbytes / 1e9:.2f} GB")
    runner = FNORunner(cfg, params, device=dev, max_slots=ONE_CARD_SLOTS)
    print(f"[serve] warmup of buckets {runner.buckets}: {runner.warmup():.2f}s")
    requests, _ = build_scenarios(cfg, 4, 2, seed=0, steps=2)
    spectral_fused_cuda.launches = 0
    done, dt, sched = serve(runner, requests, ONE_CARD_SLOTS)
    launches = spectral_fused_cuda.launches
    check_served(done, requests, sched.failed)
    _report_serving("serve", done, dt, runner)
    _check_launches("serve", launches, cfg.n_blocks, runner.batched_steps, gpu)
    worst = verify(runner, done, 2)
    print(f"[serve] verify OK vs the unfused plain forward (max abs diff {worst:.3e})")
    return launches


def phase_ensemble(gpu: str) -> dict:
    """The same size as a UQ ensemble through the deep-split geomodel cache;
    returns the spectral kernel's launch count of each pass."""
    import torch

    from repro_torch.configs.fno_sleipner import ONE_CARD_SLOTS
    from repro_torch.core.fno import init_params
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda
    from repro_torch.launch.serve_pde import build_scenarios, check_served, serve, verify
    from repro_torch.serve import FNORunner

    cfg = _serving_cfg(in_channels=2)
    dev = torch.device("cuda")
    _free_cuda()
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    runner = FNORunner(cfg, params, device=dev, max_slots=ONE_CARD_SLOTS, n_static=1,
                       cache_level="deep", cache_bytes=16 << 30)
    print(f"[ensemble] warmup of buckets {runner.buckets}: {runner.warmup():.2f}s")
    passes, launches = [], {}
    for tag in ("cold", "warm"):
        requests, _ = build_scenarios(cfg, 4, 2, seed=0, steps=2, n_static=1)
        forwards = runner.batched_steps
        spectral_fused_cuda.launches = 0
        done, dt, sched = serve(runner, requests, ONE_CARD_SLOTS)
        launches[f"ensemble_{tag}"] = spectral_fused_cuda.launches
        check_served(done, requests, sched.failed)
        _report_serving(f"ensemble {tag}", done, dt, runner)
        _check_launches(f"ensemble {tag}", launches[f"ensemble_{tag}"], cfg.n_blocks,
                        runner.batched_steps - forwards, gpu)
        passes.append(sorted(done, key=lambda r: r.rid))
    stats = runner.cache.stats
    print(f"[ensemble] cache hit-rate {stats['hit_rate']:.3f} ({stats['hits']} hits / {stats['misses']} misses); {gpu}")
    if not stats["hit_rate"] > 0:
        raise SystemExit("[ensemble] the geomodel cache never hit")
    for cold, warm in zip(*passes):
        for a, b in zip(cold.outputs, warm.outputs):
            if not np.array_equal(a, b):
                raise SystemExit(f"[ensemble] rid {cold.rid}: cold and warm outputs differ")
    print("[ensemble] cold == warm bitwise")
    worst = verify(runner, passes[0], 2)
    print(f"[ensemble] verify OK vs the unfused plain forward (max abs diff {worst:.3e})")
    return launches


def phase_cli(gpu: str) -> int:
    """The serving CLI on a small checkpoint the port writes, with --verify;
    returns the spectral kernel's launch count of its served run."""
    import tempfile

    import torch

    from repro_torch.core.fno import FNOConfig, init_params
    from repro_torch.train import checkpoint

    _free_cuda()  # the subprocess needs the memory this process has cached
    cfg = FNOConfig(grid=(16, 8, 8, 8), modes=(4, 2, 2, 3), width=8, in_channels=2,
                    n_blocks=2, decoder_dim=16)
    with tempfile.TemporaryDirectory() as d:
        params = init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
        checkpoint.save(d, 1, {"params": params})
        with open(os.path.join(d, "fno_config.json"), "w") as f:
            json.dump({
                "grid": list(cfg.grid), "modes": list(cfg.modes), "width": cfg.width,
                "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
                "n_blocks": cfg.n_blocks, "decoder_dim": cfg.decoder_dim,
                "model_shards": [1], "normalized": ["x"], "normalizer": "meanstd",
                "x_stats": {"mean": [0.5, 0.1], "std": [1.2, 0.3]}, "y_stats": None,
            }, f)
        cmd = [sys.executable, "-m", "repro_torch.launch.serve_pde", "--ckpt-dir", d,
               "--scenarios", "4", "--max-batch", "2", "--rollout-steps", "2",
               "--ensemble", "--dup", "2", "--verify", "--bench-sequential"]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    print("\n".join("[cli] " + line for line in out.stdout.strip().splitlines()))
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"[cli] serve_pde exited {out.returncode}")
    m = re.search(r"spectral kernel launches: (\d+) over (\d+) forwards", out.stdout)
    if m is None:
        raise SystemExit("[cli] serve_pde printed no spectral kernel launch count")
    return _check_launches("cli", int(m.group(1)), cfg.n_blocks, int(m.group(2)), gpu)


def _train_cfg():
    import dataclasses

    from repro_torch.configs.fno_sleipner import CONFIG, ONE_CARD_TRAIN_GRID

    return dataclasses.replace(CONFIG, grid=ONE_CARD_TRAIN_GRID)


def phase_train(gpu: str) -> dict:
    """Full-width training on one card: every leaf's gradient through the
    fused path against the unfused forward's, then 4 steps of the train
    step. Returns each kernel's launch count over the 4 steps."""
    import torch

    from repro_torch.configs.fno_sleipner import ONE_CARD_TRAIN_ACCUM, ONE_CARD_TRAIN_BATCH
    from repro_torch.core.fno import fno_forward, fno_forward_unfused, init_params, mse_loss
    from repro_torch.data.loader import NdArraySource, ShardedDatasetLoader
    from repro_torch.kernels.spectral_conv import spectral_fused_cuda, spectral_fused_dw_cuda
    from repro_torch.launch.train import synthetic_fno_data
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state, warmup_cosine
    from repro_torch.train.train_loop import accumulate_grads, make_train_step, zeros_like_tree

    cfg = _train_cfg()
    steps, accum = 4, ONE_CARD_TRAIN_ACCUM
    print("reduced: grid 256x128x64 -> 64x32x32")
    print(f"[train] config {cfg}; batch {ONE_CARD_TRAIN_BATCH} as {accum} micro-batches")
    dev = torch.device("cuda")
    _free_cuda()
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    x_all, y_all = synthetic_fno_data(cfg, 4, seed=0)
    loader = ShardedDatasetLoader({"x": NdArraySource(x_all), "y": NdArraySource(y_all)},
                                  ONE_CARD_TRAIN_BATCH, device=dev, seed=0)
    try:
        def loss_of(forward):
            return lambda p, b: (mse_loss(forward(p, b["x"], cfg), b["y"]), {})

        def sum_sq_of(forward):
            # the squared error summed, not averaged: the same gradients
            # times the grid's 5.8M points, so the gate's relative term
            # rules and not its 1e-6 floor
            return lambda p, b: (mse_loss(forward(p, b["x"], cfg), b["y"]) * b["y"].numel(), {})

        micro = {k: v[: ONE_CARD_TRAIN_BATCH // accum] for k, v in loader.batch(0).items()}
        grads = {}
        for tag, forward in (("fused", fno_forward), ("unfused", fno_forward_unfused)):
            grads[tag] = zeros_like_tree(params)
            t0 = time.perf_counter()
            accumulate_grads(sum_sq_of(forward), params, micro, grads[tag])
            torch.cuda.synchronize()
            print(f"[train] {tag} forward + backward at micro-batch 1: "
                  f"{time.perf_counter() - t0:.3f}s; {gpu}")
        for group, leaves in grads["unfused"].items():
            for name, ref in leaves.items():
                _gate(f"train grad {group}.{name} fused vs unfused", grads["fused"][group][name], ref)
        del grads, micro
        _free_cuda()

        opt = init_opt_state(params)
        step = make_train_step(loss_of(fno_forward),
                               AdamWConfig(lr=warmup_cosine(1e-3, 10, steps)), grad_accum=accum)
        spectral_fused_cuda.launches = spectral_fused_dw_cuda.launches = 0
        times, metrics = [], []
        for i in range(steps):
            batch = loader.batch(i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
        launches = {"fused": spectral_fused_cuda.launches, "dw": spectral_fused_dw_cuda.launches}
    finally:
        loader.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, (t, m) in enumerate(zip(times, metrics)):
        print(f"[train] step {i}: loss {m['loss']:.6e} grad_norm {m['grad_norm']:.6e} "
              f"lr {m['lr']:.3e} in {t:.3f}s")
    print(f"[train] {steps} steps: mean step {np.mean(times[1:]):.3f}s after the first "
          f"({times[0]:.3f}s); max_memory_allocated {peak:.2f} GiB; {gpu}")
    if not all(np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        raise SystemExit("[train] a loss or grad norm is not finite")
    want = {"fused": steps * cfg.n_blocks * 3 * accum, "dw": steps * cfg.n_blocks * accum}
    print(f"[train] launches over {steps} steps: fused {launches['fused']} (want {want['fused']}: "
          f"forward, remat recompute, dx), dw {launches['dw']} (want {want['dw']}); {gpu}")
    if launches != want:
        raise SystemExit("[train] the training steps did not launch the kernels as expected")
    del params, opt
    return launches


def phase_train_cli(gpu: str) -> dict:
    """The training CLI on the card with an injected fault, then the serving
    CLI with --verify on its checkpoint; returns the launch counts of both."""
    import tempfile

    _free_cuda()  # the subprocesses need the memory this process has cached
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "fno",
               "--steps", "6", "--save-every", "2", "--inject-fault", "3", "--width", "8",
               "--n-data", "8", "--use-pallas", "--ckpt-dir", d]
        out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
        print("\n".join("[train_cli] " + line for line in out.stdout.strip().splitlines()))
        if out.returncode != 0:
            print(out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"[train_cli] train exited {out.returncode}")
        if "failures=1 restores=1" not in out.stdout:
            raise SystemExit("[train_cli] the injected fault was not restored from a checkpoint")
        m = re.search(r"spectral kernel launches: fused (\d+), dw (\d+) over (\d+) train steps "
                      r"x (\d+) blocks x (\d+) micro-batches", out.stdout)
        if m is None:
            raise SystemExit("[train_cli] train printed no kernel launch counts")
        fused, dw, n_steps, n_blocks, accum = map(int, m.groups())
        if n_steps == 0 or fused != n_steps * n_blocks * 3 * accum or dw != n_steps * n_blocks * accum:
            raise SystemExit(f"[train_cli] launches fused {fused}, dw {dw} do not match "
                             f"{n_steps} steps x {n_blocks} blocks x {accum} micro-batches")
        serve_cmd = [sys.executable, "-m", "repro_torch.launch.serve_pde", "--ckpt-dir", d,
                     "--scenarios", "4", "--max-batch", "2", "--rollout-steps", "2", "--verify"]
        srv = subprocess.run(serve_cmd, capture_output=True, text=True, env=env, timeout=600)
    print("\n".join("[train_cli] " + line for line in srv.stdout.strip().splitlines()))
    if srv.returncode != 0 or "verify OK" not in srv.stdout:
        print(srv.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"[train_cli] serve_pde exited {srv.returncode} without verify OK")
    m = re.search(r"spectral kernel launches: (\d+) over (\d+) forwards", srv.stdout)
    if m is None:
        raise SystemExit("[train_cli] serve_pde printed no spectral kernel launch count")
    served = _check_launches("train_cli serve", int(m.group(1)), n_blocks, int(m.group(2)), gpu)
    print(f"[train_cli] train launches fused {fused}, dw {dw} over {n_steps} steps; {gpu}")
    return {"fused": fused, "dw": dw, "serve": served}


def _finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def _lm_check(tag, got, ref) -> float:
    """Fail unless got is within the gate of its dtype (``LM_F32_TOL``,
    ``LM_BF16_*``) of ref everywhere; returns max|d|."""
    if tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
        raise SystemExit(f"[{tag}] {tuple(got.shape)} {got.dtype} != {tuple(ref.shape)} {ref.dtype}")
    import torch

    g, r = got.float(), ref.float()
    d = (g - r).abs()
    err, top = float(d.max()), float(r.abs().max())
    if got.dtype == torch.float32:
        rel, absolute = LM_F32_TOL, LM_F32_TOL
    else:
        rel, absolute = LM_BF16_REL, LM_BF16_ABS_OF_MAX * top
    excess = float((d - (absolute + rel * r.abs())).max())
    print(f"[{tag}] max|d|={err:.3e} (gate {absolute:.3g} + {rel:.3g}|ref|, max|ref|={top:.3e})")
    if not excess <= 0 or not _finite(g):
        raise SystemExit(f"[{tag}] kernel disagrees with its plain version")
    return err


def _rmsnorm_bound_ms(rows, d, nbytes_el) -> tuple:
    """x read once, w once, y written once; 4 f32 flops per element."""
    nbytes = 2 * rows * d * nbytes_el + 4 * d
    return _bound_ms(nbytes, 4 * rows * d)


def _flash_bound_ms(b, h, kvh, sq, sk, d, causal, nbytes_el) -> tuple:
    """q, k, v read once, o written once; 4 d flops per visible (query, key)
    pair (the causal cut counted for these lengths), against the
    tensor-core rate for bf16 operands (whose products are exact in f32)
    and the f32 rate for f32."""
    if causal:
        pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq))
    else:
        pairs = sq * sk
    nbytes = nbytes_el * d * (2 * b * h * sq + 2 * b * kvh * sk)
    flops = 4 * d * b * h * pairs
    rate = BF16_FLOP_PER_S if nbytes_el == 2 else FP32_FLOP_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_lm_kernels(gpu: str) -> tuple:
    """RMSNorm and flash attention vs their plain versions on the card, then
    timed at the serving path's shapes; returns their two records."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    types = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, device=dev, generator=gen) * scale).to(types[dtype])

    # rmsnorm: (rows, d, dtype); the last two are a gemma-7b prefill of
    # 1000 tokens and a decode step over 4 slots
    rms_cases = [(1, 8, "float32"), (37, 96, "bfloat16"), (256, 96, "float32"),
                 (300, 8, "bfloat16"), (300, 3072, "float32"), (300, 3072, "bfloat16"),
                 (1000, 3072, "float32"), (4, 3072, "float32"),
                 (1000, 3072, "bfloat16"), (4, 3072, "bfloat16")]
    rms = {}
    for rows, d, dtype in rms_cases:
        x = randn((rows, d), dtype, 3.0)
        w = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        got = rmsnorm(x, w)
        torch.cuda.synchronize()
        err = _lm_check(f"rmsnorm {rows}x{d} {dtype}", got, rmsnorm_ref(x, w))
        if d == 3072 and dtype == "bfloat16" and rows in (1000, 4):
            ms = device_ms(lambda: rmsnorm(x, w))
            plain = device_ms(lambda: rmsnorm_ref(x, w))
            lib = device_ms(lambda: F.rms_norm(x.float(), (d,), w, eps=1e-6).to(x.dtype))
            call = cuda_loop_ms(lambda: rmsnorm(x, w))
            bound, by = _rmsnorm_bound_ms(rows, d, 2)
            print(f"[rmsnorm] {rows}x{d} bf16, device time: kernel {ms * 1e3:.2f} us, plain "
                  f"{plain * 1e3:.2f} us, F.rms_norm {lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
                  f"({by}); back-to-back calls of the wrapper {call * 1e3:.2f} us each; {gpu}")
            rms[rows] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                             bound_ms=bound, bound_by=by, call_ms=call)
    rms_record = {
        "name": "rmsnorm", "route": "cuda", "source": RMSNORM_SOURCE,
        "replaces": RMSNORM_REPLACES, "launches": None, **rms[1000],
        "shape": "x [1000, 3072] bf16 (a 1000-token prefill)",
        "decode_shape": "x [4, 3072] bf16", "decode_ms": rms[4]["ms"], "decode_call_ms": rms[4]["call_ms"],
        "decode_plain_ms": rms[4]["plain_ms"], "decode_library_ms": rms[4]["library_ms"],
        "decode_bound_ms": rms[4]["bound_ms"],
    }

    # flash: (name, b, h, kvh, sq, sk, d, causal, dtype, timed)
    flash_cases = [
        ("mha causal", 2, 4, 4, 100, 100, 32, True, "float32", False),
        ("gqa ragged", 1, 8, 2, 130, 130, 64, True, "bfloat16", False),
        ("mqa sq<sk", 1, 4, 1, 50, 200, 16, True, "float32", False),
        ("non-causal cross", 2, 2, 2, 64, 192, 128, False, "float32", False),
        ("d256 causal", 1, 2, 2, 140, 140, 256, True, "bfloat16", False),
        ("d256 gqa sq<sk", 1, 4, 2, 33, 129, 256, True, "float32", False),
        ("mqa non-causal", 1, 4, 1, 70, 70, 128, False, "bfloat16", False),
        # the path shapes in f32 too, where the gate holds the arithmetic tight
        ("gemma-7b prefill f32", 1, 16, 16, 1000, 1000, 256, True, "float32", False),
        ("chatglm3-6b gqa prefill f32", 1, 32, 2, 777, 777, 128, True, "float32", False),
        ("minitron-8b prefill f32", 1, 32, 8, 1000, 1000, 128, True, "float32", False),
        ("gemma-7b prefill", 1, 16, 16, 1000, 1000, 256, True, "bfloat16", True),
        ("chatglm3-6b gqa prefill", 1, 32, 2, 777, 777, 128, True, "bfloat16", True),
        ("minitron-8b prefill", 1, 32, 8, 1000, 1000, 128, True, "bfloat16", True),
    ]
    flash = {}
    for name, b, h, kvh, sq, sk, d, causal, dtype, timed in flash_cases:
        # [b, s, heads, d] swapped to [b, heads, s, d]: the layer's strided views
        q = randn((b, sq, h, d), dtype).transpose(1, 2)
        k = randn((b, sk, kvh, d), dtype).transpose(1, 2)
        v = randn((b, sk, kvh, d), dtype).transpose(1, 2)
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = _lm_check(f"flash {name} b{b} h{h} kvh{kvh} sq{sq} sk{sk} d{d} {dtype}", got,
                        flash_attention_ref(q, k, v, causal=causal))
        if not timed:
            continue
        ms = device_ms(lambda: flash_attention(q, k, v, causal=causal), n=10)
        plain = device_ms(lambda: flash_attention_ref(q, k, v, causal=causal), n=5)
        mask = causal_lower_right(sq, sk)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True), n=10)
        bound, by = _flash_bound_ms(b, h, kvh, sq, sk, d, causal, 2)
        print(f"[flash] {name}, device time: kernel {ms:.3f} ms, plain {plain:.3f} ms, SDPA "
              f"{lib:.3f} ms (kernel / SDPA {ms / lib:.2f}), bound {bound * 1e3:.2f} us ({by}); {gpu}")
        flash[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                           bound_ms=bound, bound_by=by)
        del q, k, v, got
        torch.cuda.empty_cache()
    flash_record = {
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": None, **flash["gemma-7b prefill"],
        "shape": "q/k/v [1, 16, 1000, 256] bf16 causal (a gemma-7b prefill layer)",
        "other_shapes": {k: {"ms": v["ms"], "plain_ms": v["plain_ms"],
                             "library_ms": v["library_ms"], "bound_ms": v["bound_ms"]}
                         for k, v in flash.items() if k != "gemma-7b prefill"},
    }
    return rms_record, flash_record


@contextlib.contextmanager
def plain_kernels():
    """Within the block, the LM layers call the kernels' plain versions on
    CUDA tensors; for checking the served path, never on it."""
    import repro_torch.kernels.flash_attention as flash_pkg
    import repro_torch.kernels.rmsnorm as rms_pkg
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.kernels.rmsnorm import rmsnorm_ref

    saved = rms_pkg.rmsnorm, flash_pkg.flash_attention
    rms_pkg.rmsnorm = lambda x, w, eps=1e-6: rmsnorm_ref(x, w, eps)
    flash_pkg.flash_attention = flash_attention_ref
    try:
        yield
    finally:
        rms_pkg.rmsnorm, flash_pkg.flash_attention = saved


LM_ARCH, LM_SLOTS, LM_REQUESTS, LM_MAX_TOKENS, LM_MAX_LEN = "gemma-7b", 4, 8, 16, 1040


def phase_lm_serving(gpu: str) -> dict:
    """Full-width gemma-7b through Engine, then 2 prompts' logits through the
    kernels vs the plain versions; returns the kernels' launch counts."""
    import gc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.models import init_lm_params, lm_decode_step, lm_prefill
    from repro_torch.models.transformer import norms_per_forward
    from repro_torch.serve import Engine, Request

    cfg = get_arch(LM_ARCH)
    print(f"[lm] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads x {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.approx_params() / 1e9:.2f} B params; random weights (seed 0)")
    dev = torch.device("cuda")
    _free_cuda()
    t0 = time.perf_counter()
    params = init_lm_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = Engine(cfg, params, max_len=LM_MAX_LEN, max_batch=LM_SLOTS, device=dev)
    del params  # the f32 masters; the runner holds bf16 matmul weights
    gc.collect()
    torch.cuda.synchronize()
    runner = engine.runner
    held = sum(t.numel() * t.element_size() for t in _leaves(runner.params))
    cache = sum(t.numel() * t.element_size() for t in runner.cache["layers"].values())
    print(f"[lm] weights set up in {time.perf_counter() - t0:.1f}s; peak while casting the f32 "
          f"masters {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the runner holds "
          f"{held / 1e9:.2f} GB of weights and a {cache / 1e9:.2f} GB bf16 KV cache")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    rng = np.random.default_rng(0)
    lengths = rng.integers(200, 1001, size=LM_REQUESTS)
    prompts = [rng.integers(1, cfg.vocab, size=int(n)).tolist() for n in lengths]
    print(f"[lm] {LM_REQUESTS} requests, prompt lengths {lengths.tolist()}, max_tokens "
          f"{LM_MAX_TOKENS}, max_len {LM_MAX_LEN}, {LM_SLOTS} slots")
    for rid, prompt in enumerate(prompts):
        engine.submit(Request(rid=rid, prompt=prompt, max_tokens=LM_MAX_TOKENS))
    rmsnorm_cuda.launches = flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    done = engine.run_until_done()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"rmsnorm": rmsnorm_cuda.launches, "flash": flash_attention_cuda.launches}
    if engine.failed:
        raise SystemExit(f"[lm] {len(engine.failed)} requests failed: {engine.failed[0].error!r}")
    if len(done) != LM_REQUESTS or any(
            len(r.output) != LM_MAX_TOKENS or not all(0 <= t < cfg.vocab for t in r.output)
            for r in done):
        raise SystemExit("[lm] a request did not return max_tokens valid token ids")
    prefills, steps = len(runner.prefill_s), len(runner.decode_s)
    tokens = sum(len(r.output) for r in done)
    print(f"[lm] served {len(done)} requests, {tokens} tokens in {dt:.3f}s: "
          f"{tokens / dt:.1f} tok/s; {prefills} prefills, mean {np.mean(runner.prefill_s) * 1e3:.1f} ms "
          f"(prompt mean {lengths.mean():.0f} tokens); {steps} decode steps, mean "
          f"{np.mean(runner.decode_s) * 1e3:.2f} ms, median {np.median(runner.decode_s) * 1e3:.2f} ms; "
          f"max_memory_allocated while serving {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {gpu}")
    for r in sorted(done, key=lambda r: r.rid)[:2]:
        print(f"[lm]   req {r.rid}: {len(r.prompt)} prompt tokens -> {r.output}")
    want = {"rmsnorm": norms_per_forward(cfg) * (prefills + steps), "flash": cfg.n_layers * prefills}
    print(f"[lm] launches: rmsnorm {launches['rmsnorm']} (want {norms_per_forward(cfg)} x "
          f"({prefills} prefills + {steps} decode steps) = {want['rmsnorm']}), flash "
          f"{launches['flash']} (want {cfg.n_layers} x {prefills} = {want['flash']}); {gpu}")
    if prefills != LM_REQUESTS or launches != want:
        raise SystemExit("[lm] the served run did not launch the kernels as expected")

    # 2 prompts through the kernels and through the plain versions
    first = {r.rid: r.output[0] for r in done}
    params = runner.params
    for rid in (0, 1):
        prompt = torch.tensor([prompts[rid]], dtype=torch.long, device=dev)
        n = prompt.shape[1]
        out = {}
        for tag in ("kernels", "plain"):
            with torch.inference_mode(), (plain_kernels() if tag == "plain" else contextlib.nullcontext()):
                before = (rmsnorm_cuda.launches, flash_attention_cuda.launches)
                logits, cache = lm_prefill(params, prompt, cfg, max_len=n + 1)
                tok = torch.argmax(logits, -1)[:, None]
                step, _ = lm_decode_step(params, tok, cache, n, cfg)
                moved = (rmsnorm_cuda.launches, flash_attention_cuda.launches) != before
                if moved != (tag == "kernels"):
                    raise SystemExit(f"[lm] the {tag} check did not run through the {tag}")
                out[tag] = (logits.float(), step.float(), int(tok))
                del cache
        if out["kernels"][2] != first[rid]:
            raise SystemExit(f"[lm] req {rid}: prefill's greedy token {out['kernels'][2]} != the "
                             f"engine's {first[rid]}")
        for i, what in enumerate(("prefill last-token", "first decode step")):
            got, ref = out["kernels"][i], out["plain"][i]
            err, scale = float((got - ref).abs().max()), float(ref.abs().max())
            print(f"[lm] req {rid} ({n} tokens) {what} logits, kernels vs plain: max|d|={err:.3e} "
                  f"(gate {LM_LOGIT_GATE} x max|ref|={scale:.3e}); greedy tokens "
                  f"{int(got.argmax())} / {int(ref.argmax())}")
            if not (err <= LM_LOGIT_GATE * scale and _finite(got)):
                raise SystemExit(f"[lm] req {rid}: {what} logits disagree with the plain path")
    del engine, runner, params
    _free_cuda()
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def phase_lm_cli(gpu: str) -> dict:
    """The LM serving CLI (reduced gemma-7b) on the card; returns its counts."""
    _free_cuda()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    print("\n".join("[lm_cli] " + line for line in out.stdout.strip().splitlines()))
    if out.returncode != 0:
        print(out.stderr[-4000:], file=sys.stderr)
        raise SystemExit(f"[lm_cli] serve exited {out.returncode}")
    m = re.search(r"kernel launches: rmsnorm (\d+) over (\d+) prefills \+ (\d+) decode steps "
                  r"x (\d+) norms; flash_attention (\d+) over (\d+) prefills x (\d+) layers",
                  out.stdout)
    if m is None:
        raise SystemExit("[lm_cli] serve printed no kernel launch counts")
    rms, prefills, steps, norms, flash, prefills2, n_layers = map(int, m.groups())
    if prefills == 0 or rms != norms * (prefills + steps) or flash != n_layers * prefills2 \
            or prefills2 != prefills:
        raise SystemExit(f"[lm_cli] launches rmsnorm {rms}, flash {flash} do not match "
                         f"{prefills} prefills + {steps} decode steps")
    print(f"[lm_cli] launches rmsnorm {rms}, flash {flash}; {gpu}")
    return {"rmsnorm": rms, "flash": flash}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    gpu = gpu_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}; {gpu}")
    t0 = time.perf_counter()
    phase_build()
    fused = phase_kernels(gpu)
    dx, dw = phase_backward_kernels(gpu)
    fused.update(dx)
    flat, flat_dw = phase_flat_kernels(gpu)
    served = {"serve": phase_serving(gpu), **phase_ensemble(gpu), "cli": phase_cli(gpu)}
    rms, flash = phase_lm_kernels(gpu)
    train = phase_train(gpu)
    train_cli = phase_train_cli(gpu)
    lm = phase_lm_serving(gpu)
    lm_cli = phase_lm_cli(gpu)
    fused["launches"] = train["fused"]
    fused["launches_by_path"] = {
        **served, "train": train["fused"], "train_cli": train_cli["fused"],
        "train_cli_serve": train_cli["serve"],
    }
    dw["launches"] = train["dw"]
    dw["launches_by_path"] = {"train": train["dw"], "train_cli": train_cli["dw"]}
    rms["launches"] = lm["rmsnorm"]
    rms["launches_by_path"] = {"lm_serve": lm["rmsnorm"], "lm_cli": lm_cli["rmsnorm"]}
    flash["launches"] = lm["flash"]
    flash["launches_by_path"] = {"lm_serve": lm["flash"], "lm_cli": lm_cli["flash"]}
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(gpu)
    print(json.dumps({"kernels": [fused, dw, flat, flat_dw, rms, flash]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
