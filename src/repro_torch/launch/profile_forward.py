"""Where a served tick's and a training step's time go on the card, from
``torch.profiler``.

    PYTHONPATH=src python -m repro_torch.launch.profile_forward --out profile.txt
    PYTHONPATH=src python -m repro_torch.launch.profile_forward --lm --out lm.txt
    PYTHONPATH=src python -m repro_torch.launch.profile_forward --lm-train --out lm_train.txt

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

With ``--lm`` it profiles the LM serving path instead: gemma-7b at full
width with random weights through ``TransformerRunner`` (4 slots, max_len
1040, as ``chip_smoke.py`` serves it). After warm-up admissions into three
slots and a warm-up decode step, it traces one prefill of a 1000-token
prompt and then one decode step over the 4 active slots, and prints for
each the wall time, device busy time, idle share, the number of kernel
launches and of top-level host operations, device time by kernel group
(flash attention, RMSNorm, GEMMs, the rest) and the kernels with the most
device time.

With ``--lm-train`` it traces one LM training step at the shape
``chip_smoke.py`` trains: gemma-7b at full width with its depth cut to 4
layers, batch 2 x 1024 tokens as 2 micro-batches, remat on, bf16
activations, AdamW on f32 masters, after a warm-up step. It prints the
same report, and the step's parts between CUDA events: the micro-batches'
forwards and backwards, and the AdamW update.
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
LM_PROMPTS = (1000, 800, 600, 400)  # the traced prefill's, then the warm slots'
# kernel groups of the LM report, by substring of the kernel's name
LM_GROUPS = (("flash attention", ("flash_kernel",)), ("rmsnorm", ("rmsnorm_kernel",)),
             ("GEMM", ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")))


def device_spans(trace_path: str, cats=DEVICE_SPANS) -> list:
    """Sorted (start, end) in microseconds of the device spans of the given
    categories in a Chrome trace as ``export_chrome_trace`` writes it."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in cats
    )


def profile_spans(prof, cats=("kernel",)) -> list:
    """``device_spans`` of a finished ``torch.profiler`` profile (kernels
    only by default)."""
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        return device_spans(trace, cats)


def union_ms(spans) -> float:
    """Milliseconds covered by the union of sorted (start, end) spans in
    microseconds."""
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def busy_ms(trace_path: str, cats=DEVICE_SPANS) -> float:
    """Milliseconds covered by the union of the trace's device spans of the
    given categories (a Chrome trace as ``export_chrome_trace`` writes it)."""
    return union_ms(device_spans(trace_path, cats))


def kernel_ms_by_name(trace_path: str) -> dict:
    """Device milliseconds and launches of each kernel name in a Chrome
    trace: {name: (ms, launches)}."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            ms, n = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (ms + float(e["dur"]) / 1e3, n + 1)
    return out


def host_ops(prof) -> int:
    """Top-level host operations of a finished profile: PyTorch operators
    and the runtime calls made outside any of them (a ctypes launch)."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.events()
               if e.cpu_parent is None and e.device_type == DeviceType.CPU)


def _traced(prof, by_name=False) -> tuple:
    """(busy_ms, kernel_ms) of a finished profile, and with ``by_name`` the
    device ms and launches of each kernel name."""
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "trace.json")
        prof.export_chrome_trace(trace)
        out = (busy_ms(trace), busy_ms(trace, ("kernel",)))
        return out + (kernel_ms_by_name(trace),) if by_name else out


def group_kernel_ms(by_name: dict) -> dict:
    """Kernel ms summed into ``LM_GROUPS`` (first match wins), the rest last."""
    groups = {name: 0.0 for name, _ in LM_GROUPS}
    groups["other"] = 0.0
    for kernel, (ms, _) in by_name.items():
        low = kernel.lower()
        group = next((g for g, keys in LM_GROUPS if any(k.lower() in low for k in keys)), "other")
        groups[group] += ms
    return groups


def _lm_report(tag, prof, wall_ms, gpu) -> str:
    busy, kernels, by_name = _traced(prof, by_name=True)
    launches = sum(n for _, n in by_name.values())
    lines = [f"{tag}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms (kernels alone "
             f"{kernels:.2f} ms), idle share {1 - busy / wall_ms:.3f} (traced); "
             f"{launches} kernel launches, {host_ops(prof)} top-level host operations; {gpu}"]
    for group, ms in group_kernel_ms(by_name).items():
        lines.append(f"  {group}: {ms:.3f} ms ({ms / max(kernels, 1e-9):.1%} of kernel time)")
    lines.append("  kernels with the most device time (ms, launches):")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        lines.append(f"    {ms:9.3f} ms {n:5d}x  {name[:100]}")
    return "\n".join(lines)


def _profile_lm(dev, gpu) -> str:
    """Trace one full-width gemma-7b prefill and one 4-slot decode step."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import init_lm_params
    from repro_torch.serve import Request, TransformerRunner

    cfg = get_arch("gemma-7b")
    params = init_lm_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    runner = TransformerRunner(cfg, params, max_len=1040, max_slots=len(LM_PROMPTS), device=dev)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab, size=n).tolist(), max_tokens=64)
            for i, n in enumerate(LM_PROMPTS)]
    slots = [None] + reqs[1:]
    for slot in range(1, len(reqs)):
        runner.admit(slot, reqs[slot])
    runner.step(slots, list(range(1, len(reqs))))
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.admit(0, reqs[0])
        wall_p = (time.perf_counter() - t0) * 1e3
    report = _lm_report(f"gemma-7b prefill of {LM_PROMPTS[0]} tokens", prof, wall_p, gpu)
    slots[0] = reqs[0]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner.step(slots, list(range(len(reqs))))
        wall_d = (time.perf_counter() - t0) * 1e3
    lengths = [runner._lengths[i] for i in range(len(reqs))]
    report += "\n" + _lm_report(f"gemma-7b decode step, {len(reqs)} slots at lengths {lengths}",
                                prof, wall_d, gpu)
    return report


def _profile_lm_train(dev, gpu) -> str:
    """Trace one gemma-7b training step (``configs/gemma_7b.py``'s
    ``ONE_CARD_TRAIN_*``) after a warm-up step; the report, and the step's
    parts between CUDA events."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.gemma_7b import (
        ONE_CARD_TRAIN_ACCUM as LM_TRAIN_ACCUM,
        ONE_CARD_TRAIN_BATCH as LM_TRAIN_BATCH,
        ONE_CARD_TRAIN_LAYERS as LM_TRAIN_LAYERS,
        ONE_CARD_TRAIN_SEQ as LM_TRAIN_SEQ,
    )
    from repro_torch.data.tokens import SyntheticTokens
    from repro_torch.models import init_lm_params, lm_loss

    cfg = dataclasses.replace(get_arch("gemma-7b"), n_layers=LM_TRAIN_LAYERS)
    params = init_lm_params(cfg, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    opt = init_opt_state(params)
    events = {}

    def mark(name):
        events[name] = torch.cuda.Event(enable_timing=True)
        events[name].record()

    step = make_train_step(lambda p, b: lm_loss(p, b, cfg), AdamWConfig(lr=1e-4),
                           grad_accum=LM_TRAIN_ACCUM, mark=mark)
    data = SyntheticTokens(cfg.vocab, LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=0)

    def batch(i):
        return {k: torch.from_numpy(v).to(dev, torch.long) for k, v in data.batch(i).items()}

    params, opt, _ = step(params, opt, batch(0))
    second = batch(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mark("start")
        params, opt, _ = step(params, opt, second)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    parts = (f"  between CUDA events: {LM_TRAIN_ACCUM} micro-batches' forward + backward "
             f"{events['start'].elapsed_time(events['backward']):.2f} ms, AdamW "
             f"{events['backward'].elapsed_time(events['updated']):.2f} ms; max_memory_allocated "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    tag = (f"gemma-7b train step, {LM_TRAIN_LAYERS} of 28 layers, batch {LM_TRAIN_BATCH} x "
           f"{LM_TRAIN_SEQ} as {LM_TRAIN_ACCUM} micro-batches, remat on")
    return _lm_report(tag, prof, wall, gpu) + "\n" + parts


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
    ap.add_argument("--lm", action="store_true", help="profile the LM serving path instead")
    ap.add_argument("--lm-train", action="store_true",
                    help="profile an LM training step (gemma-7b, 4 layers) instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    if args.lm or args.lm_train:
        # bf16 GEMMs accumulate in f32 and round once, as the reference's XLA ones
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        report = _profile_lm_train(dev, gpu) if args.lm_train else _profile_lm(dev, gpu)
        print(report)
        if args.out:
            with open(args.out, "w") as f:
                f.write(report + "\n")
        return
    cfg = dataclasses.replace(CONFIG, grid=ONE_CARD_GRID)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)

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
