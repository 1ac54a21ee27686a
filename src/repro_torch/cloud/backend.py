"""Execution backends for the clusterless batch API.

The port's copy of ``repro.cloud.backend``, with two changes. The
process backend's workers are spawned, not forked (the reference's
``ProcessPoolExecutor()`` forks), and run one CPU thread each: a forked
child cannot use CUDA once its parent has, and the online trainer's
parent always has. Results cross processes as pickled blobs, so a task
returns numpy, never CUDA tensors. And a start marker's temporary file is
named for its thread as well as its process, as the object store's blobs
are (``objectstore.py``).

``LocalProcessBackend``  — real parallel execution in worker processes
  (the stand-in for Azure Batch VMs); tasks are
  (fn-ref, BlobRef-args) payloads resolved through the object store, like
  Redwood's runtime deserializing uploaded ASTs.
``ThreadBackend``        — in-process, for tests.
``SimBackend``           — timing/cost SIMULATION of an Azure Batch pool
  (VM startup distribution, per-task submission latency, spot preemptions)
  used by the Fig. 4/8 benchmarks; executes nothing.
"""
from __future__ import annotations

import dataclasses
import math
import multiprocessing
import os
import pickle
import random
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

from repro_torch.cloud.objectstore import BlobRef, ObjectStore


# -- payload resolution (the "Redwood runtime" on each worker) ---------------

def mark_task_started(store_root: str, task_id: int, t0: float) -> None:
    """Publish the task's actual start time as a tiny marker object.

    Backends queue tasks behind a finite worker pool, so submission time is
    NOT start time; the pool's straggler speculation reads these markers to
    avoid backup-submitting tasks that are merely queued (atomic rename, so
    a half-written marker is never observed)."""
    d = os.path.join(store_root, "starts")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"task_{task_id}")
    tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as f:
        f.write(repr(t0))
    os.rename(tmp, path)


def read_task_started(store_root: str, task_id: int) -> Optional[float]:
    """Actual start time of a task, or None while it is still queued."""
    try:
        with open(os.path.join(store_root, "starts", f"task_{task_id}")) as f:
            return float(f.read())
    except (FileNotFoundError, ValueError):
        return None


def run_task(store_root: str, fn_ref: bytes, arg_refs: Sequence, task_id: int):
    """Worker-side entry: deserialize fn + args (BlobRefs fetched), run,
    store the result as a blob (Redwood replaces `return` with a blob
    upload), return the result's BlobRef."""
    store = ObjectStore(store_root)
    fn: Callable = pickle.loads(fn_ref)
    args = [a.fetch() if isinstance(a, BlobRef) else a for a in arg_refs]
    t0 = time.time()
    mark_task_started(store_root, task_id, t0)
    result = fn(*args)
    runtime = time.time() - t0
    ref = store.put(result)
    return {
        "task_id": task_id,
        "result_ref": ref,
        "runtime_s": runtime,
        "started_at": t0,
        "pid": os.getpid(),
    }


def _worker_init() -> None:
    """A worker's start: one CPU thread for its numerical libraries."""
    os.environ["OMP_NUM_THREADS"] = "1"
    import torch

    torch.set_num_threads(1)


class LocalProcessBackend:
    """Parallel worker processes over the shared-filesystem object store,
    spawned (a fresh interpreter each: safe beside CUDA and threads)."""

    def __init__(self, max_workers: int = 4):
        self.max_workers = max_workers
        self._pool = ProcessPoolExecutor(
            max_workers=max_workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init,
        )

    def submit(self, store_root: str, fn: Callable, arg_refs: Sequence, task_id: int):
        fn_ref = pickle.dumps(fn)
        return self._pool.submit(run_task, store_root, fn_ref, arg_refs, task_id)

    def shutdown(self):
        self._pool.shutdown(wait=True)


class ThreadBackend:
    def __init__(self, max_workers: int = 4):
        self.max_workers = max_workers
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix="batchpool")

    def submit(self, store_root: str, fn: Callable, arg_refs: Sequence, task_id: int):
        fn_ref = pickle.dumps(fn)
        return self._pool.submit(run_task, store_root, fn_ref, arg_refs, task_id)

    def shutdown(self):
        self._pool.shutdown(wait=True)


# -- simulated Azure Batch (for scaling/cost benchmarks) ---------------------

@dataclasses.dataclass
class SimConfig:
    """Calibrated to the paper's measurements:
    Fig. 4a — job submission ~16 s at 1 024 tasks (per-task upload bound);
    Fig. 8a — ~50% of 1 000 VMs up at 3.5 min, most by 6 min."""
    submit_base_s: float = 1.0          # one-time codegen + AST upload
    submit_per_task_s: float = 0.015    # per-task argument upload
    vm_startup_median_s: float = 210.0
    vm_startup_sigma: float = 0.35      # lognormal spread
    spot: bool = False
    spot_preempt_per_hour: float = 0.05
    seed: int = 0


@dataclasses.dataclass
class SimReport:
    n_tasks: int
    n_vms: int
    submit_time_s: float
    makespan_s: float
    total_core_seconds: float
    preemptions: int
    vm_ready_times: List[float]
    task_end_times: List[float]

    def weak_scaling_efficiency(self, task_runtime_s: float) -> float:
        """Paper Fig. 4b metric: the only serial component is submission,
        so eff = T_parallel_ideal / (T_parallel_ideal + T_submit)."""
        ideal = self.n_tasks * task_runtime_s / self.n_vms
        return ideal / (ideal + self.submit_time_s)

    def end_to_end_efficiency(self, task_runtime_s: float) -> float:
        """Stricter than the paper: counts VM startup + round quantization
        (useful work / pool-seconds over the real makespan)."""
        useful = self.n_tasks * task_runtime_s
        return useful / (self.n_vms * self.makespan_s)


class SimBackend:
    """Discrete-event model of a batch pool: submission, VM startup,
    greedy task placement, optional spot preemption + retry."""

    def __init__(self, cfg: SimConfig = SimConfig()):
        self.cfg = cfg

    def run_job(
        self, n_tasks: int, n_vms: int, task_runtime_s: float | Callable[[int], float]
    ) -> SimReport:
        rng = random.Random(self.cfg.seed)
        runtime = (
            task_runtime_s if callable(task_runtime_s) else (lambda i: task_runtime_s)
        )
        submit = self.cfg.submit_base_s + self.cfg.submit_per_task_s * n_tasks
        ready = sorted(
            rng.lognormvariate(math.log(self.cfg.vm_startup_median_s), self.cfg.vm_startup_sigma)
            for _ in range(n_vms)
        )
        # greedy earliest-available placement; tasks re-queued on preemption.
        # Azure Batch starts scheduling as soon as tasks arrive (paper §V-A),
        # so task i becomes available at its own submission time, overlapping
        # submission with execution.
        import heapq

        avail = [
            self.cfg.submit_base_s + self.cfg.submit_per_task_s * (i + 1)
            for i in range(n_tasks)
        ]
        vm_free = [(ready[i], i) for i in range(n_vms)]
        heapq.heapify(vm_free)
        queue = list(range(n_tasks))
        end_times = [0.0] * n_tasks
        core_seconds = 0.0
        preemptions = 0
        while queue:
            t = queue.pop(0)
            free_at, vm = heapq.heappop(vm_free)
            free_at = max(free_at, avail[t])
            dur = runtime(t)
            if self.cfg.spot:
                p = 1.0 - math.exp(-self.cfg.spot_preempt_per_hour * dur / 3600.0)
                if rng.random() < p:
                    # preempted partway: wasted work, task retried
                    frac = rng.random()
                    core_seconds += dur * frac
                    preemptions += 1
                    heapq.heappush(vm_free, (free_at + dur * frac, vm))
                    queue.append(t)
                    continue
            end = free_at + dur
            core_seconds += dur
            end_times[t] = end
            heapq.heappush(vm_free, (end, vm))
        return SimReport(
            n_tasks=n_tasks,
            n_vms=n_vms,
            submit_time_s=submit,
            makespan_s=max(end_times),
            total_core_seconds=core_seconds,
            preemptions=preemptions,
            vm_ready_times=ready,
            task_end_times=sorted(end_times),
        )
