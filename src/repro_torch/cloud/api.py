"""Clusterless batch computing API — the Redwood.jl analog in Python.

The port's copy of ``repro.cloud.api`` (pure Python, JAX-free).

Redwood (paper §IV-A) exposes @batchexec / @bcast / fetch over Azure Batch.
The Python equivalents here:

    pool = BatchPool(LocalProcessBackend(8), store_root="/tmp/blobs",
                     vm_type="E4s_v3", n_vms=8)
    big = pool.broadcast(velocity_model)      # upload ONCE -> BlobRef
    futs = pool.map(simulate, [(i, big) for i in range(3200)])
    results = [f.result() for f in futs]      # == fetch
    pool.cost_report()

Semantics carried over from the paper:
  * functions are executed remotely against blob-store references — the
    task payload is (pickled fn, arg refs), mirroring serialized ASTs;
  * broadcast uploads once and fans out a reference (paper Fig. 4a: the
    argument upload, not the broadcast, dominates submission);
  * tasks are independent/idempotent; results are blobs (fetch copies back);
  * straggler mitigation (beyond-paper, motivated by Fig. 8b's runtime
    tail): optional speculative re-execution of tasks slower than k x the
    median of completed ones, first finisher wins.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.cloud.backend import LocalProcessBackend, read_task_started
from repro_torch.cloud.objectstore import BlobRef, ObjectStore

# On-demand $/hr (paper's price table [53], rounded); spot ~ 0.4x.
VM_PRICES = {
    "E4s_v3": 0.25,
    "E8s_v3": 0.50,
    "HBv3": 3.60,
    "ND96amsr": 32.77,
}
SPOT_DISCOUNT = 0.4


def remote(fn: Callable) -> Callable:
    """Tag a module-level function for remote execution (@everywhere).
    Plain pickle serializes functions by reference, so remote workers must
    be able to import the module — same constraint as Redwood's @everywhere
    tagging, enforced here at submission time."""
    fn.__redwood_remote__ = True
    return fn


@dataclasses.dataclass
class TaskRecord:
    task_id: int
    submitted_at: float
    started: Optional[float] = None
    runtime_s: Optional[float] = None
    speculated: bool = False
    # BlobRefs of the first submission's uploaded args, reused verbatim by
    # speculative resubmission (paper Fig. 4a: the argument upload dominates
    # submission cost, so backup tasks must not pay it twice).
    arg_refs: Optional[List[BlobRef]] = None


class BatchFuture:
    def __init__(self, pool: "BatchPool", task_id: int, inner):
        self._pool = pool
        self.task_id = task_id
        self._inners = [inner]
        self._lock = threading.Lock()

    def add_speculative(self, inner):
        with self._lock:
            self._inners.append(inner)

    def done(self) -> bool:
        return any(i.done() for i in self._inners)

    def result(self, timeout: Optional[float] = None) -> Any:
        """Fetch: first completed attempt wins."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            for inner in list(self._inners):
                if inner.done():
                    payload = inner.result()
                    self._pool._record_finish(self.task_id, payload)
                    return payload["result_ref"].fetch()
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(f"task {self.task_id}")
            time.sleep(0.005)


class BatchPool:
    def __init__(
        self,
        backend=None,
        *,
        store_root: str,
        vm_type: str = "E4s_v3",
        n_vms: int = 4,
        spot: bool = False,
    ):
        self.backend = backend or LocalProcessBackend(n_vms)
        self.store = ObjectStore(store_root)
        self.store_root = store_root
        self.vm_type = vm_type
        self.n_vms = n_vms
        self.spot = spot
        self.records: dict = {}
        self._next_id = 0
        self.submit_times: List[float] = []

    # -- primitives ---------------------------------------------------------
    def broadcast(self, obj: Any) -> BlobRef:
        return self.store.put(obj)

    def submit(self, fn: Callable, args: Sequence[Any]) -> BatchFuture:
        t0 = time.time()
        arg_refs = [a if isinstance(a, BlobRef) else self.store.put(a) for a in args]
        task_id = self._next_id
        self._next_id += 1
        inner = self.backend.submit(self.store_root, fn, arg_refs, task_id)
        self.records[task_id] = TaskRecord(
            task_id, submitted_at=time.time(), arg_refs=arg_refs
        )
        self.submit_times.append(time.time() - t0)
        return BatchFuture(self, task_id, inner)

    def map(
        self,
        fn: Callable,
        args_list: Sequence[Sequence[Any]],
        *,
        speculative: bool = False,
        straggler_factor: float = 2.0,
    ) -> List[Any]:
        futures = [self.submit(fn, args) for args in args_list]
        if not speculative:
            return [f.result() for f in futures]
        return self._map_speculative(fn, futures, straggler_factor)

    def _map_speculative(self, fn, futures, factor):
        """Re-submit laggards once >60% of tasks finished (backup tasks)."""
        results: dict = {}
        runtimes: List[float] = []
        speculated = set()
        while len(results) < len(futures):
            for i, f in enumerate(futures):
                if i in results:
                    continue
                if f.done():
                    results[i] = f.result()
                    rec = self.records[f.task_id]
                    if rec.runtime_s is not None:
                        runtimes.append(rec.runtime_s)
            if runtimes and len(results) >= 0.6 * len(futures):
                median = sorted(runtimes)[len(runtimes) // 2]
                for i, f in enumerate(futures):
                    if i in results or i in speculated:
                        continue
                    rec = self.records[f.task_id]
                    if rec.started is None:
                        rec.started = read_task_started(self.store_root, f.task_id)
                    if rec.started is None:
                        # still queued behind a full worker pool — a backup
                        # submission would just join the same queue; only a
                        # task that has actually STARTED can be a straggler
                        continue
                    running = time.time() - rec.started
                    if running > factor * max(median, 1e-3):
                        # args were uploaded (or content-addressed) at first
                        # submission; reuse those refs instead of re-uploading
                        arg_refs = self.records[f.task_id].arg_refs
                        f.add_speculative(
                            self.backend.submit(self.store_root, fn, arg_refs, f.task_id)
                        )
                        self.records[f.task_id].speculated = True
                        speculated.add(i)
            time.sleep(0.005)
        return [results[i] for i in range(len(futures))]

    # -- accounting ----------------------------------------------------------
    def _record_finish(self, task_id: int, payload: dict):
        rec = self.records.get(task_id)
        if rec is not None and rec.runtime_s is None:
            rec.runtime_s = payload["runtime_s"]
            rec.started = payload.get("started_at", rec.started)

    def cost_report(self) -> dict:
        """$ cost model per the paper: core-hours x VM price (spot discount)."""
        price = VM_PRICES.get(self.vm_type, 1.0) * (SPOT_DISCOUNT if self.spot else 1.0)
        runtimes = [r.runtime_s for r in self.records.values() if r.runtime_s]
        total_hours = sum(runtimes) / 3600.0
        return {
            "tasks": len(self.records),
            "vm_type": self.vm_type,
            "spot": self.spot,
            "task_hours": total_hours,
            "usd": total_hours * price,
            "mean_task_s": sum(runtimes) / max(len(runtimes), 1),
            "speculated": sum(1 for r in self.records.values() if r.speculated),
            "mean_submit_s": sum(self.submit_times) / max(len(self.submit_times), 1),
        }

    def shutdown(self):
        self.backend.shutdown()
