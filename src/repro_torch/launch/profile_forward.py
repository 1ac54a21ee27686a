"""Where a served tick's and a training step's time go on the card, from
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_forward --out profile.txt

Serves the Sleipner config (width 40, modes (24,16,8,10), 4 blocks) with
random weights at the shape ``chip_smoke.py`` serves (``ONE_CARD_GRID``,
buckets up to ``ONE_CARD_SLOTS``). It times ``ITERS`` bare forwards at the
full bucket with CUDA events, then traces one served tick through
``FNORunner`` and the ``Scheduler`` (host staging, forward, copy back,
feedback). Then it trains the same model at the shape ``chip_smoke.py``
trains (``ONE_CARD_TRAIN_GRID``, batch ``ONE_CARD_TRAIN_BATCH`` as
``ONE_CARD_TRAIN_ACCUM`` micro-batches, remat on) and traces one step
after a warm-up step. For each trace it prints the wall time, the device's
busy time (the union of its kernel, copy and memset intervals), the idle
share, and the ops with the most device time. Needs a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs.fno_sleipner import (
    CONFIG,
    ONE_CARD_GRID,
    ONE_CARD_SLOTS,
    ONE_CARD_TRAIN_ACCUM,
    ONE_CARD_TRAIN_BATCH,
    ONE_CARD_TRAIN_GRID,
)
from repro_torch.core.fno import fno_forward, init_params, mse_loss
from repro_torch.data.loader import NdArraySource, ShardedDatasetLoader
from repro_torch.launch.serve_pde import build_scenarios
from repro_torch.launch.train import synthetic_fno_data
from repro_torch.serve import FNORunner, Scheduler
from repro_torch.train.optimizer import AdamWConfig, init_opt_state, warmup_cosine
from repro_torch.train.train_loop import make_train_step

ITERS, ROWS = 3, 25
DEVICE_SPANS = ("kernel", "gpu_memcpy", "gpu_memset")


def busy_ms(trace_path: str, cats=DEVICE_SPANS) -> float:
    """Milliseconds covered by the union of the trace's device spans of the
    given categories (a Chrome trace as ``export_chrome_trace`` writes it)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in cats
    )
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def _traced(prof) -> tuple:
    """(busy_ms, kernel_ms) of a finished profile."""
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        return busy_ms(trace), busy_ms(trace, ("kernel",))


def _profile_train_step(dev) -> tuple:
    """Trace one full-width training step after a warm-up step; returns
    (wall_ms, busy_ms, kernel_ms, peak_gib, table)."""
    cfg = dataclasses.replace(CONFIG, grid=ONE_CARD_TRAIN_GRID)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    opt = init_opt_state(params)
    x_all, y_all = synthetic_fno_data(cfg, 4, seed=0)
    step = make_train_step(
        lambda p, b: (mse_loss(fno_forward(p, b["x"], cfg), b["y"]), {}),
        AdamWConfig(lr=warmup_cosine(1e-3, 10, 2)), grad_accum=ONE_CARD_TRAIN_ACCUM,
    )
    with ShardedDatasetLoader({"x": NdArraySource(x_all), "y": NdArraySource(y_all)},
                              ONE_CARD_TRAIN_BATCH, device=dev, seed=0) as loader:
        torch.cuda.reset_peak_memory_stats()
        params, opt, _ = step(params, opt, loader.batch(0))
        batch = loader.batch(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, opt, _ = step(params, opt, batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    busy, kernels = _traced(prof)
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=ROWS)
    return wall, busy, kernels, peak, table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(CONFIG, grid=ONE_CARD_GRID)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    x = torch.randn((ONE_CARD_SLOTS, cfg.in_channels) + cfg.grid, device=dev)
    with torch.inference_mode():
        fno_forward(params, x, cfg)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fno_forward(params, x, cfg)
        end.record()
        end.synchronize()
    forward_ms = start.elapsed_time(end) / ITERS
    del x

    runner = FNORunner(cfg, params, device=dev, max_slots=ONE_CARD_SLOTS)
    runner.warmup()
    sched = Scheduler(runner, ONE_CARD_SLOTS)
    for r in build_scenarios(cfg, ONE_CARD_SLOTS, 2, seed=0, steps=3)[0]:
        sched.submit(r)
    sched.step()  # admits the scenarios; the traced tick is a mid-rollout one
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_active = sched.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, kernels = _traced(prof)

    head = (
        f"fno_forward batch {ONE_CARD_SLOTS} grid {cfg.grid} width {cfg.width}: "
        f"{forward_ms:.2f} ms per forward (CUDA events, mean of {ITERS}); {gpu}\n"
        f"served tick, {n_active} active slots: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms (kernels alone {kernels:.2f} ms), idle share "
        f"{1 - busy / wall_ms:.3f} (traced); {gpu}"
    )
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=ROWS)
    print(head)
    print(table)

    del runner, sched, params, prof
    torch.cuda.empty_cache()
    t_wall, t_busy, t_kernels, t_peak, t_table = _profile_train_step(dev)
    t_head = (
        f"train step batch {ONE_CARD_TRAIN_BATCH} as {ONE_CARD_TRAIN_ACCUM} micro-batches, "
        f"grid {ONE_CARD_TRAIN_GRID} width {CONFIG.width}, remat on: wall {t_wall:.2f} ms, "
        f"device busy {t_busy:.2f} ms (kernels alone {t_kernels:.2f} ms), idle share "
        f"{1 - t_busy / t_wall:.3f} (traced); max_memory_allocated {t_peak:.2f} GiB; {gpu}"
    )
    print(t_head)
    print(t_table)
    if args.out:
        with open(args.out, "w") as f:
            f.write(head + "\n" + table + "\n" + t_head + "\n" + t_table + "\n")


if __name__ == "__main__":
    main()
