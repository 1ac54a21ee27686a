#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and hold its kernels to their plain versions.

    python3 chip_smoke.py

Phases, each failing hard:
  1. build the CUDA kernel library from the repository's sources;
  2. hold the fused spectral kernel against its plain PyTorch version
     (``spectral_apply_fused_ref`` + ``pad_kept_ref``) over the trunc
     patterns, t tails, ``add`` and the full-width serving block shape,
     and time both with CUDA events; then the weight-cotangent kernel
     against ``spectral_fused_dw_ref`` over the trunc patterns, t tails
     and the layouts that rfftn and the irfftn backward hand it, and the
     fused op's autograd backward (dx on the fused kernel, dW on the
     cotangent kernel) against plain autograd; both backward kernels are
     timed at the training block shape;
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
     checkpoint it wrote.

Each served run must launch the fused kernel exactly once per FNO block
per forward; each training step, per micro-batch and block, three times
(forward, remat recompute, dx) and the cotangent kernel once.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and as the last line ``{"ok": true, "device": {...}}``. Exits non-zero
without a result when there is no CUDA device.
"""
from __future__ import annotations

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
TOL_REL, TOL_ABS = 1e-4, 1e-6

KERNEL_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_fused.cu"
KERNEL_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:217"
DW_SOURCE = "src/repro_torch/kernels/spectral_conv/csrc/spectral_fused_dw.cu"
DW_REPLACES = "src/repro/kernels/spectral_conv/kernel.py:307"


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


def phase_build() -> float:
    from repro_torch.kernels.spectral_conv.build import load_library

    t0 = time.perf_counter()
    load_library()
    dt = time.perf_counter() - t0
    print(f"[build] spectral kernel library built/loaded in {dt:.1f}s")
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA {torch.version.cuda}; {gpu}")
    t0 = time.perf_counter()
    phase_build()
    fused = phase_kernels(gpu)
    dx, dw = phase_backward_kernels(gpu)
    fused.update(dx)
    served = {"serve": phase_serving(gpu), **phase_ensemble(gpu), "cli": phase_cli(gpu)}
    train = phase_train(gpu)
    train_cli = phase_train_cli(gpu)
    fused["launches"] = train["fused"]
    fused["launches_by_path"] = {
        **served, "train": train["fused"], "train_cli": train_cli["fused"],
        "train_cli_serve": train_cli["serve"],
    }
    dw["launches"] = train["dw"]
    dw["launches_by_path"] = {"train": train["dw"], "train_cli": train_cli["dw"]}
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(gpu)
    print(json.dumps({"kernels": [fused, dw]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
