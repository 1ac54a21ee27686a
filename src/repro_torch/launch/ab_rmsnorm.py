"""A/B of RMSNorm launch plans on the card, in one process.

    PYTHONPATH=src python -m repro_torch.launch.ab_rmsnorm [--first-version DIR]

The kernel (``kernels/rmsnorm/csrc/rmsnorm.cu``) takes its plan -- vector
width, vectors a thread, threads a row, rows a CTA -- as arguments, so one
build serves every plan. At each bf16 shape the LLM paths give it (a
1000-token prefill and a 4-slot decode step at d = 512, 1024, 2048, 2560
and 3072), and at 4 rows of one 16-byte vector (d = 8: the floor of a
launch that loads, reduces and stores), it launches the plan ``launch_plan`` picks and the other plans
that cover the row, holds each against the plain version (one bf16
rounding), and prints each plan's device time from one ``torch.profiler``
trace per shape (20 launches a plan, plans in turns: A B ... then ... B A;
the median of each plan's 40 kernel spans) beside the bound. With
``--first-version DIR`` (the root of a checkout of an earlier tree), that
tree's ``rmsnorm.cu`` is built too and timed in the same trace, through its
own C interface (no plan arguments), if it has that interface, and at d =
3072 the committed ``rmsnorm_cuda`` and the first version's host path are
timed a call back to back. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from repro_torch.common.constants import HBM_BANDWIDTH as HBM_BYTES_PER_S
from repro_torch.kernels.build import KernelLibrary, build
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.launch.profile_forward import profile_spans

WIDTHS = (512, 1024, 2048, 2560, 3072)
# (rows, d): a 1000-token prefill and a 4-slot decode step at every width,
# and a decode step of one 16-byte vector a row: the floor of a launch that
# loads, reduces and stores
SHAPES = [(1000, d) for d in WIDTHS] + [(4, d) for d in (8,) + WIDTHS]
NV_CHOICES = (1, 2, 3, 4, 5, 6, 8)
RPC_CHOICES = (1, 2, 4, 8, 16, 32)


def candidate_plans(rows: int, d: int, itemsize: int) -> list:
    """Every vectorised plan the kernel takes for this shape: for each
    vectors-a-thread choice, the fewest threads a row that cover it, and
    each rows-a-CTA choice (one row a CTA, or a warp's worth, while the
    rows are fewer than the SMs) that ``ops.plan_ok`` passes, without
    duplicates; ``launch_plan``'s own first."""
    vec = 16 // itemsize
    n_vec = d // vec
    plans = [ops.launch_plan(rows, d, itemsize, True)]
    for nv in NV_CHOICES:
        tpr = ops.threads_a_row(-(-n_vec // nv))
        if -(-n_vec // tpr) != nv:
            continue
        for rpc in RPC_CHOICES if rows >= ops.SMS else (1, 32 // min(tpr, 32)):
            plan = ops.LaunchPlan(vec, nv, tpr, rpc)
            if ops.plan_ok(plan, d, itemsize) and plan not in plans:
                plans.append(plan)
    return plans


def device_ms_in_turns(fns: dict, n: int = 20, tag: str = "ab") -> dict:
    """Median device time of each callable (one kernel a call) from one
    ``torch.profiler`` trace: each ``n`` times, in turns forward then
    backward. A trace that lost kernel events is taken again (twice)."""
    from torch.profiler import ProfilerActivity, profile

    order = list(fns) + list(fns)[::-1]
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for name in order:
                for _ in range(n):
                    fns[name]()
            torch.cuda.synchronize()
        spans = [(e - s) / 1e3 for s, e in profile_spans(prof)]
        if len(spans) == n * len(order):
            break
        print(f"[{tag}] a trace held {len(spans)} kernels, want {n * len(order)}: again")
    else:
        raise SystemExit(f"[{tag}] three traces lost kernel events")
    times = {name: [] for name in fns}
    for i, name in enumerate(order):
        times[name] += spans[i * n:(i + 1) * n]
    return {name: float(np.median(t)) for name, t in times.items()}


def first_version(root: str):
    """The earlier tree's kernel, built as a library of its own, with its C
    interface (x, w, y, rows, d, eps, is_bf16, stream); None when that tree's
    kernel takes a plan."""
    src = os.path.join(root, "src", "repro_torch", "kernels", "rmsnorm", "csrc", "rmsnorm.cu")
    with open(src) as f:
        if "int tpr" in f.read():
            return None
    lib = ctypes.CDLL(build([KernelLibrary("ab_rmsnorm_first", (src,))])[0])
    lib.rmsnorm_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.rmsnorm_launch.restype = ctypes.c_int
    return lib


def launch_plan_of(lib, x, w, plan) -> torch.Tensor:
    d = x.shape[-1]
    y = torch.empty_like(x)
    err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // d, d, 1e-6,
                             1, *plan, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"plan {plan}: CUDA error {err}")
    return y


def launch_first(lib, x, w) -> torch.Tensor:
    d = x.shape[-1]
    y = torch.empty_like(x)
    err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // d, d, 1e-6,
                             1, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"first version: CUDA error {err}")
    return y


def first_rmsnorm_cuda(lib, x, w) -> torch.Tensor:
    """The first version's host path (its ``rmsnorm_cuda``: the device
    context entered and the stream looked up on every call) launching its
    kernel; for timing beside the committed ``rmsnorm_cuda``."""
    d = x.shape[-1]
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rmsnorm_launch(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.numel() // d, d,
                                 1e-6, 1, stream)
    if err:
        raise RuntimeError(f"first version: CUDA error {err}")
    return y


def call_us_in_turns(fns: dict, n: int = 50, reps: int = 5) -> dict:
    """Microseconds a call of each callable, from CUDA events around ``n``
    back-to-back calls (the host's pace where the kernel is shorter than
    its launch), median of ``reps``, in turns A B ... B A."""
    times = {name: [] for name in fns}
    for name in list(fns) + list(fns)[::-1]:
        fns[name]()
        torch.cuda.synchronize()
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fns[name]()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) * 1e3 / n)
    return {name: float(np.median(t)) for name, t in times.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--first-version", default=None,
                        help="root of a checkout whose rmsnorm.cu is timed beside the plans")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_rmsnorm needs a CUDA card")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lib = ops.load_library()
    first = first_version(args.first_version) if args.first_version else None
    gen = torch.Generator(device="cuda").manual_seed(4)
    for rows, d in SHAPES:
        x = (torch.randn((rows, d), device="cuda", generator=gen) * 3).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        ref = rmsnorm_ref(x, w).float()
        gate = 2.0 ** -7 * ref.abs() + 1e-3 * float(ref.abs().max())
        fns = {}
        for plan in candidate_plans(rows, d, 2):
            got = launch_plan_of(lib, x, w, plan).float()
            if not bool(((got - ref).abs() <= gate).all()):
                raise SystemExit(f"[ab_rmsnorm] {rows}x{d}: plan {plan} disagrees with the "
                                 f"plain version")
            fns[plan] = lambda plan=plan: launch_plan_of(lib, x, w, plan)
        if first is not None:
            fns["first version"] = lambda: launch_first(first, x, w)
        times = device_ms_in_turns(fns, tag="ab_rmsnorm")
        bound_us = (2 * rows * d * 2 + 4 * d) / HBM_BYTES_PER_S * 1e6
        chosen = ops.launch_plan(rows, d, 2, True)
        cells = [f"{'first version' if p == 'first version' else _label(p)}"
                 f"{' (chosen)' if p == chosen else ''} {t * 1e3:.2f} us"
                 for p, t in sorted(times.items(), key=lambda kv: kv[1])]
        print(f"[ab_rmsnorm] {rows}x{d} bf16, bound {bound_us:.2f} us (bytes): "
              + "; ".join(cells) + f"; {gpu}", flush=True)
        if first is not None and d == 3072:
            calls = call_us_in_turns({
                "rmsnorm_cuda": lambda: ops.rmsnorm_cuda(x, w, 1e-6),
                "the first version's rmsnorm_cuda": lambda: first_rmsnorm_cuda(first, x, w)})
            print(f"[ab_rmsnorm] {rows}x{d} bf16, host path a call back to back: "
                  + "; ".join(f"{k} {v:.2f} us" for k, v in calls.items()) + f"; {gpu}",
                  flush=True)


def _label(plan) -> str:
    return f"nv{plan.nv} tpr{plan.tpr} rpc{plan.rpc}"


if __name__ == "__main__":
    main()
