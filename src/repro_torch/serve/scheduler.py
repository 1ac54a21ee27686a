"""Family-generic slot scheduler: continuous batching over any ModelRunner.

(The port's own copy of ``repro.serve.scheduler``, unchanged in behaviour:
importing the reference's would run ``repro.serve``'s package imports,
which load JAX.)

The serving subsystem is split into two layers. This module is the
model-agnostic half: a fixed pool of ``max_slots`` request slots, continuous
admission (a queued request is installed the moment a slot frees — no
full-batch barrier, "continuous batching" a la Orca/vLLM), per-slot
progress, retirement hooks, and in-flight request DEDUP: when the runner
can key requests by content (``request_key``), an identical request
submitted while its twin is queued/active attaches to that primary as a
follower — it never occupies a slot, and the primary's outputs are fanned
out to it at retirement (``fanout``). What a "step" computes is delegated
to a ``ModelRunner`` — one batched decode for the token engine, one batched
FNO surrogate application for PDE scenarios — so LLM token requests and
PDE-scenario requests share exactly this scheduling logic.

The contract the runner must honor:

  * ``admit(slot, request)`` installs the request's state into ``slot``
    (prefill + cache install for tokens; normalize + stage the input field
    for scenarios). Called once per request, before its first step. If it
    raises, the scheduler marks the request FAILED (``request.error`` set,
    collected in ``Scheduler.failed``) and stays serviceable — the slot is
    offered to the next queued request.
  * ``step(slots, active)`` advances EVERY active slot by one unit of
    progress in a single batched computation, mutates the requests with
    their new outputs, and returns the slot indices that just finished.
  * ``retire(slot, request)`` releases per-slot state after the scheduler
    pulls the request out of the pool (optional cleanup; slots are reused).
  * ``request_key(request)`` (optional) — a hashable content key (or None
    to opt a request out); equal keys mean byte-identical work, enabling
    dedup. Runners providing it must also provide
    ``fanout(primary, follower)`` to copy a retired primary's outputs onto
    a follower.

Requests are opaque to the scheduler except for the attributes it manages:
``done`` (set True on retirement/failure), ``error`` (the admit exception,
on failure), and the latency timestamps (``submitted_s`` / ``admitted_s``
/ ``finished_s``, ``time.perf_counter`` values) that the serving CLIs
report per-request latency from. Two OPTIONAL request attributes feed the
admission policy: ``priority`` (int, higher admitted first when slots
contend) and ``deadline_s`` (relative seconds from submission; within a
priority class the earliest absolute deadline is admitted first — EDF).
Requests carrying neither behave exactly as before: pure FIFO.
"""
from __future__ import annotations

import math
import time
import warnings
from collections import deque
from typing import List, Optional, Protocol, Sequence


class ModelRunner(Protocol):
    """What the scheduler needs from a model family (see module docstring)."""

    def admit(self, slot: int, request) -> None: ...

    def step(self, slots: Sequence[Optional[object]], active: Sequence[int]) -> Sequence[int]: ...

    def retire(self, slot: int, request) -> None: ...


class Scheduler:
    """Slot pool + continuous admission + dedup + retirement over a ModelRunner."""

    def __init__(self, runner: ModelRunner, max_slots: int, *, dedup: bool = True):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.runner = runner
        self.max_slots = max_slots
        self.slots: List[Optional[object]] = [None] * max_slots
        self.queue: deque = deque()
        self.finished: list = []
        self.failed: list = []
        self.steps = 0
        # dedup state: primaries in flight by content key; followers by
        # primary identity (requests need not be hashable themselves)
        self._request_key = getattr(runner, "request_key", None) if dedup else None
        self._primary_by_key: dict = {}
        self._followers: dict = {}
        self.dedup_attached = 0
        self._seq = 0  # FIFO tie-break for the priority/deadline order

    # -- API ----------------------------------------------------------------
    def submit(self, request) -> None:
        request.submitted_s = time.perf_counter()
        request._seq = self._seq
        self._seq += 1
        deadline = getattr(request, "deadline_s", None)
        request._deadline_abs = (
            request.submitted_s + deadline if deadline is not None else None
        )
        if self._request_key is not None:
            key = self._request_key(request)
            if key is not None:
                primary = self._primary_by_key.get(key)
                if primary is not None:
                    # identical work already queued/active: ride its slot.
                    # A follower is admitted when its PRIMARY is: attaching
                    # to a still-queued primary leaves admitted_s unset
                    # (stamped in admit_waiting alongside the primary), so
                    # follower latency stats see the real queue wait.
                    if getattr(primary, "admitted_s", None) is not None:
                        request.admitted_s = time.perf_counter()
                    self._followers.setdefault(id(primary), []).append(request)
                    self.dedup_attached += 1
                    return
                self._primary_by_key[key] = request
                request._dedup_key = key
        self.queue.append(request)

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)

    def pending(self) -> int:
        """Requests not yet finished/failed: queued + active + followers."""
        n_active = len(self.active_slots())
        n_followers = sum(len(f) for f in self._followers.values())
        return len(self.queue) + n_active + n_followers

    def admit_waiting(self) -> List[int]:
        """Fill free slots from the queue (priority > deadline > FIFO).
        Returns admitted slots.

        A request whose ``runner.admit`` raises is marked failed (not
        silently dropped) and the freed slot is offered to the next queued
        request — one bad request cannot wedge the pool.
        """
        admitted = []
        for i, occupant in enumerate(self.slots):
            if occupant is not None:
                continue
            while self.queue:
                request = self._pop_next()
                try:
                    self.runner.admit(i, request)
                except Exception as exc:  # noqa: BLE001 — any admit error
                    self._fail(request, exc)
                    continue
                request.admitted_s = time.perf_counter()
                # followers that attached while this primary was queued
                # become admitted with it (they ride this very slot)
                for follower in self._followers.get(id(request), []):
                    if getattr(follower, "admitted_s", None) is None:
                        follower.admitted_s = request.admitted_s
                self.slots[i] = request
                admitted.append(i)
                break
        return admitted

    def step(self) -> int:
        """One tick: admit, one batched runner step, retire. Returns the
        number of slots that were active during the step."""
        self.admit_waiting()
        active = self.active_slots()
        if not active:
            return 0
        finished = self.runner.step(self.slots, active)
        self.steps += 1
        for i in finished:
            request = self.slots[i]
            self.runner.retire(i, request)
            request.done = True
            request.finished_s = time.perf_counter()
            self.finished.append(request)
            self.slots[i] = None
            self._resolve_dedup(request)
        return len(active)

    def run_until_done(self, max_steps: int = 1000) -> list:
        """Drive ticks until the pool drains. ``max_steps`` budgets THIS
        call, not the scheduler's lifetime — a reused scheduler (a gateway
        drains it once per arrival wave) gets a fresh budget every call,
        instead of spuriously bailing once cumulative ``self.steps``
        crosses the threshold. If the budget is exhausted with work still
        queued/active, the partial result is NOT silent: a RuntimeWarning
        reports how many requests are unfinished."""
        start_steps = self.steps
        while self.has_work() and self.steps - start_steps < max_steps:
            self.step()
        if self.has_work():
            warnings.warn(
                f"run_until_done: max_steps={max_steps} exhausted with "
                f"{self.pending()} request(s) still queued/active "
                f"({len(self.finished)} finished, {len(self.failed)} failed) "
                f"— raise max_steps",
                RuntimeWarning,
                stacklevel=2,
            )
        return self.finished

    def drain_unfinished(self) -> list:
        """Remove and return every not-yet-finished request: queued, active
        in a slot, and dedup followers. The failover path — a gateway pulls
        unfinished work off a replica whose runner broke and resubmits it
        elsewhere. The runner is deliberately NOT consulted (it may be the
        broken thing); slots are cleared and dedup state reset so the
        requests can be submitted to a different scheduler."""
        orphans = list(self.queue)
        self.queue.clear()
        for i, request in enumerate(self.slots):
            if request is not None:
                orphans.append(request)
                self.slots[i] = None
        for followers in self._followers.values():
            orphans.extend(followers)
        self._followers.clear()
        self._primary_by_key.clear()
        for request in orphans:
            if hasattr(request, "_dedup_key"):
                del request._dedup_key
        return orphans

    # -- internals ----------------------------------------------------------
    def _pop_next(self):
        """Pop the queued request to admit next: highest ``priority``, then
        earliest absolute deadline (EDF), then submission order. Requests
        without either attribute all share the default key, so the scan
        degenerates to exact FIFO."""
        best_i, best_key = 0, self._admit_order(self.queue[0])
        for i in range(1, len(self.queue)):
            key = self._admit_order(self.queue[i])
            if key < best_key:
                best_i, best_key = i, key
        if best_i == 0:
            return self.queue.popleft()
        request = self.queue[best_i]
        del self.queue[best_i]
        return request

    @staticmethod
    def _admit_order(request) -> tuple:
        deadline = getattr(request, "_deadline_abs", None)
        return (
            -(getattr(request, "priority", 0) or 0),
            deadline if deadline is not None else math.inf,
            getattr(request, "_seq", 0),
        )

    def _fail(self, request, exc: Exception) -> None:
        request.error = exc
        request.done = True
        request.finished_s = time.perf_counter()
        self.failed.append(request)
        # followers were promised this primary's outputs: fail them too
        key = getattr(request, "_dedup_key", None)
        if key is not None and self._primary_by_key.get(key) is request:
            del self._primary_by_key[key]
        for follower in self._followers.pop(id(request), []):
            follower.error = exc
            follower.done = True
            follower.finished_s = time.perf_counter()
            self.failed.append(follower)

    def _resolve_dedup(self, request) -> None:
        key = getattr(request, "_dedup_key", None)
        if key is not None and self._primary_by_key.get(key) is request:
            del self._primary_by_key[key]
        followers = self._followers.pop(id(request), [])
        for follower in followers:
            self.runner.fanout(request, follower)
            follower.done = True
            follower.finished_s = time.perf_counter()
            self.finished.append(follower)
