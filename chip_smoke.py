#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one H100 and hold its kernel to its plain version.

    python3 chip_smoke.py

Phases, each failing hard:
  1. build the CUDA kernel library from the repository's sources;
  2. hold the CUDA spectral kernel against its plain PyTorch version
     (``spectral_apply_fused_ref`` + ``pad_kept_ref``) over the trunc
     patterns, t tails, ``add`` and the full-width serving block shape,
     and time both with CUDA events;
  3. serve the Sleipner FNO (width 40, modes (24,16,8,10), 4 blocks) on
     grid (128,64,32,88) through ``FNORunner`` and the ``Scheduler``,
     checking every output against the plain unfused forward;
  4. the same size as an ensemble (2 input channels, 1 static geomodel)
     through the deep-split cache: hit-rate > 0, cold == warm bitwise,
     verified likewise;
  5. the serving CLI on a small checkpoint written by the port, with
     ``--verify``, as a subprocess.

Each served run (phase 3, both passes of phase 4, phase 5) must launch the
spectral kernel exactly once per FNO block per forward.

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


def _fused_bound_ms(b, ci, co, ext, kept, t_in, t_out, with_add) -> tuple:
    """(bound_ms, bound_by): bytes the function must move (w once, the kept
    part of x once, add once, the full output once) over HBM bandwidth vs
    its float32 operations over the FP32 peak."""
    k1, k2, k3, kt = kept
    n_kept = k1 * k2 * k3 * kt
    out_elems = b * co * ext[0] * ext[1] * ext[2] * t_out
    nbytes = 8 * (ci * co * n_kept + b * ci * n_kept + out_elems
                  + (b * co * n_kept if with_add else 0))
    flops = 8 * b * ci * co * n_kept
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    record = phase_kernels(gpu)
    record["launches"] = phase_serving(gpu)
    record["launches_by_path"] = {
        "serve": record["launches"], **phase_ensemble(gpu), "cli": phase_cli(gpu),
    }
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f}s")
    print(gpu)
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
