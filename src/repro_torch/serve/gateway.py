"""Multi-replica serving gateway: one front door, N scheduler replicas.

(The port's own copy of ``repro.serve.gateway`` over the port's
``Scheduler``, unchanged in behaviour: importing the reference's would run
``repro.serve``'s package imports, which load JAX. A replica may be an
``FNORunner`` over rank groups; ``fno_runner.link_replicas`` lets R of them
share one start of the ranks.)

The paper's payoff is a surrogate that serves commercial-scale scenario
workloads orders of magnitude faster than the numerical simulator — at
production traffic that is a FLEET problem, not a scheduler problem. One
``Scheduler`` drives one (data x model) serving mesh; this module is the
front-end above it (the shape of rtp-llm's flexlb master/worker balancer):
requests enter through ``Gateway.submit`` and are ROUTED to one of N
independent replicas, each its own ``ModelRunner`` + ``Scheduler`` (and in
production its own host / mesh slice — replicas may be heterogeneous in
model-shard layout, slot count, or even checkpoint).

Routing policies (``policy=``):

  * ``least-pending`` (default) — backlog-aware: the replica with the
    fewest unfinished requests (queued + active + dedup followers, the
    slot-pool stats the scheduler already tracks) wins; deterministic
    index tie-break.
  * ``round-robin`` — cyclic, backlog-blind (the contrast baseline).
  * ``affinity``    — cache-affinity: requests whose runner reports an
    ``affinity_key`` (the geomodel content hash for FNO serving) stick to
    the replica that first served that key, so per-replica
    ``GeomodelCache`` hit-rates match the single-process rate and
    byte-identical duplicates still dedup onto one slot; a first-seen key
    is placed to balance pinned keys across the fleet (backlog as the
    tie-break), keyless requests fall back to least-pending.

Request-level priority/deadline policy lives in the scheduler (``priority``
/ ``deadline_s`` request attributes) and therefore applies per replica;
the gateway only places requests.

Health and failover: a replica whose runner RAISES out of a scheduler step
is marked unhealthy and drained — its unfinished requests (queued, active,
followers) are reset (partial rollout outputs dropped) and re-routed to
healthy replicas, keeping their original ``submitted_s`` so end-to-end
latency stays honest. One broken replica cannot wedge the fleet; if no
healthy replica remains the orphans are marked failed (``Gateway.failed``)
rather than lost. Per-request admission errors stay request-level, exactly
as in a lone scheduler.

Autoscaling hook: given a ``replica_factory``, the gateway spawns a
replica when mean backlog per healthy replica crosses
``scale_up_backlog`` and retires an idle one when it falls to
``scale_down_backlog`` (within ``[min_replicas, max_replicas]``); scale
events are recorded in ``Gateway.scale_events``. The factory is also the
self-healing path: a failed replica below ``min_replicas`` is replaced.

``serve_open_loop`` drives an open-loop arrival process (arrivals do not
wait for completions) through the fleet on a measured event clock: every
tick runs the REAL scheduler/runner — real routing, admission, compute,
outputs — and its measured wall time becomes the tick's service time on
the virtual timeline. ``per_replica_executors=True`` lets replica service
times overlap, which is the deployment model (each replica is its own
serving host); ``False`` serializes all ticks on one executor — what this
single host can actually do. CI machines are single-core, so fleet
concurrency is accounted on the event clock rather than wall time — the
same precedent as the HLO async-collective overlap accounting, which is
tested on synthetic HLO until a real-ICI run exists.

With one replica and the default policy the gateway is a pass-through:
the lone scheduler sees the identical submission order and tick cadence,
so single-replica serving stays bit-identical to pre-gateway serving.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, List, Optional, Sequence

from repro_torch.serve.scheduler import Scheduler

POLICIES = ("least-pending", "round-robin", "affinity")


class ReplicaHandle:
    """One serving replica: a runner + its scheduler + health/route stats."""

    def __init__(self, index: int, runner, *, max_slots: Optional[int] = None,
                 dedup: bool = True):
        self.index = index
        self.name = f"r{index}"
        self.runner = runner
        self.sched = Scheduler(
            runner, max_slots or getattr(runner, "max_slots", 4), dedup=dedup
        )
        self.healthy = True
        self.error: Optional[Exception] = None
        self.routed = 0
        self._failed_over = False
        # how much of sched.finished/.failed the gateway has collected
        self._collected_f = 0
        self._collected_x = 0

    def pending(self) -> int:
        return self.sched.pending()

    def tick(self) -> int:
        """One scheduler step. A raising runner marks the replica unhealthy
        (request-level admission errors do NOT — the scheduler already
        contains those per-request)."""
        if not self.healthy:
            return 0
        try:
            return self.sched.step()
        except Exception as exc:  # noqa: BLE001 — any runner/step failure
            self.healthy = False
            self.error = exc
            return 0


class Gateway:
    """Load-balancing front-end over N independent scheduler replicas."""

    def __init__(
        self,
        runners: Optional[Sequence] = None,
        *,
        policy: str = "least-pending",
        replica_factory: Optional[Callable[[], object]] = None,
        min_replicas: int = 1,
        max_replicas: int = 8,
        scale_up_backlog: Optional[int] = None,
        scale_down_backlog: int = 0,
        max_slots: Optional[int] = None,
        dedup: bool = True,
    ):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r} not in {POLICIES}")
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}/{max_replicas}"
            )
        runners = list(runners or [])
        if not runners:
            if replica_factory is None:
                raise ValueError("need runners and/or a replica_factory")
            runners = [replica_factory() for _ in range(min_replicas)]
        if len(set(map(id, runners))) != len(runners):
            raise ValueError(
                "each replica needs its own runner instance (slot state "
                "is per-runner; one runner cannot back two schedulers)"
            )
        self.policy = policy
        self.replica_factory = replica_factory
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.scale_up_backlog = scale_up_backlog
        self.scale_down_backlog = scale_down_backlog
        self._max_slots = max_slots
        self._dedup = dedup
        self.replicas: List[ReplicaHandle] = [
            ReplicaHandle(i, r, max_slots=max_slots, dedup=dedup)
            for i, r in enumerate(runners)
        ]
        self._next_index = len(self.replicas)
        self.retired: List[ReplicaHandle] = []
        self._rr = 0
        self._affinity: dict = {}
        self.finished: list = []
        self.failed: list = []
        self.scale_events: list = []
        self.ticks = 0
        self.rerouted = 0

    # -- routing -------------------------------------------------------------
    def healthy_replicas(self) -> List[ReplicaHandle]:
        return [r for r in self.replicas if r.healthy]

    def _least_pending(self, pool: List[ReplicaHandle]) -> ReplicaHandle:
        return min(pool, key=lambda r: (r.pending(), r.index))

    def _pin_target(self, pool: List[ReplicaHandle]) -> ReplicaHandle:
        """Placement for a first-seen affinity key: balance pinned keys
        across replicas before backlog, so distinct geomodels spread over
        the fleet even when every replica is idle (a pure least-pending
        fallback would pin every key to replica 0 under light load)."""
        pins: dict = {}
        for r in self._affinity.values():
            pins[id(r)] = pins.get(id(r), 0) + 1
        return min(pool, key=lambda r: (pins.get(id(r), 0), r.pending(), r.index))

    def route(self, request) -> ReplicaHandle:
        """Pick the replica for ``request`` (does not submit)."""
        pool = self.healthy_replicas()
        if not pool:
            errs = "; ".join(
                f"{r.name}: {r.error}" for r in self.replicas if r.error
            )
            raise RuntimeError(f"no healthy replicas ({errs or 'none spawned'})")
        if self.policy == "affinity":
            key_fn = getattr(pool[0].runner, "affinity_key", None)
            key = key_fn(request) if key_fn is not None else None
            if key is not None:
                sticky = self._affinity.get(key)
                if sticky is not None and sticky.healthy and sticky in self.replicas:
                    return sticky
                chosen = self._pin_target(pool)
                self._affinity[key] = chosen
                return chosen
            return self._least_pending(pool)
        if self.policy == "round-robin":
            chosen = pool[self._rr % len(pool)]
            self._rr += 1
            return chosen
        return self._least_pending(pool)

    def submit(self, request) -> ReplicaHandle:
        """Route and enqueue one request; returns the chosen replica."""
        replica = self.route(request)
        replica.routed += 1
        replica.sched.submit(request)
        return replica

    # -- drive loop ----------------------------------------------------------
    def has_work(self) -> bool:
        return any(r.healthy and r.sched.has_work() for r in self.replicas)

    def pending(self) -> int:
        return sum(r.pending() for r in self.healthy_replicas())

    def tick(self) -> int:
        """One fleet round: a scheduler step on every healthy replica with
        work, failover for replicas that broke this round, collection of
        newly finished/failed requests, then the autoscale check. Returns
        the number of slots active across the fleet."""
        n_active = 0
        for replica in list(self.replicas):
            if replica.healthy and replica.sched.has_work():
                n_active += replica.tick()
            if not replica.healthy and not replica._failed_over:
                self._failover(replica)
        self._collect()
        self._autoscale()
        self.ticks += 1
        return n_active

    def tick_replica(self, replica: ReplicaHandle) -> int:
        """One step on a single replica plus the same bookkeeping
        ``tick`` does fleet-wide — the open-loop driver's granularity."""
        n_active = replica.tick()
        if not replica.healthy and not replica._failed_over:
            self._failover(replica)
        self._collect()
        self._autoscale()
        self.ticks += 1
        return n_active

    def run_until_done(self, max_steps: int = 1000) -> list:
        """Drive fleet rounds until every replica drains. ``max_steps``
        budgets this call (same per-call semantics as the scheduler)."""
        start = self.ticks
        while self.has_work() and self.ticks - start < max_steps:
            self.tick()
        if self.has_work():
            warnings.warn(
                f"Gateway.run_until_done: max_steps={max_steps} exhausted "
                f"with {self.pending()} request(s) still queued/active "
                f"({len(self.finished)} finished, {len(self.failed)} "
                f"failed) — raise max_steps",
                RuntimeWarning,
                stacklevel=2,
            )
        return self.finished

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        """Per-replica backlog/health/cache plus fleet aggregates (the
        fleet cache hit-rate sums hits/lookups over every replica's
        runner cache, including retired/unhealthy ones)."""
        replicas = []
        hits = misses = dedup = cache_bytes = 0
        store = None
        for r in self.replicas + self.retired:
            cache = getattr(r.runner, "cache", None)
            cs = cache.stats if cache is not None else None
            if cs is not None:
                hits += cs["hits"]
                misses += cs["misses"]
                cache_bytes += cs["bytes"]
            if store is None:
                store = getattr(r.runner, "cache_store", None)
            dedup += r.sched.dedup_attached
            replicas.append({
                "name": r.name,
                "healthy": r.healthy,
                "retired": r in self.retired,
                "pending": r.pending(),
                "routed": r.routed,
                "finished": len(r.sched.finished),
                "failed": len(r.sched.failed),
                "dedup_attached": r.sched.dedup_attached,
                "cache": cs,
                "error": repr(r.error) if r.error is not None else None,
            })
        lookups = hits + misses
        return {
            "replicas": replicas,
            "fleet": {
                "n_replicas": len(self.replicas),
                "n_healthy": len(self.healthy_replicas()),
                "pending": self.pending(),
                "finished": len(self.finished),
                "failed": len(self.failed),
                "dedup_attached": dedup,
                "cache_hits": hits,
                "cache_misses": misses,
                "cache_hit_rate": hits / lookups if lookups else 0.0,
                "cache_bytes": cache_bytes,
                # replicas share one store instance; report it once
                "store": store.stats if store is not None else None,
                "rerouted": self.rerouted,
                "scale_events": list(self.scale_events),
                "ticks": self.ticks,
            },
        }

    # -- internals -----------------------------------------------------------
    def _collect(self) -> None:
        for r in self.replicas:
            self._collect_replica(r)

    def _collect_replica(self, r: ReplicaHandle) -> None:
        sched = r.sched
        if len(sched.finished) > r._collected_f:
            self.finished.extend(sched.finished[r._collected_f:])
            r._collected_f = len(sched.finished)
        if len(sched.failed) > r._collected_x:
            self.failed.extend(sched.failed[r._collected_x:])
            r._collected_x = len(sched.failed)

    def _spawn(self) -> ReplicaHandle:
        replica = ReplicaHandle(
            self._next_index, self.replica_factory(),
            max_slots=self._max_slots, dedup=self._dedup,
        )
        self._next_index += 1
        self.replicas.append(replica)
        return replica

    def _retire(self, replica: ReplicaHandle) -> None:
        self._collect_replica(replica)
        self.replicas.remove(replica)
        self.retired.append(replica)
        self._affinity = {
            k: v for k, v in self._affinity.items() if v is not replica
        }

    def _failover(self, replica: ReplicaHandle) -> None:
        """Drain a broken replica and re-route its unfinished requests;
        spawn a replacement if a factory keeps the fleet below minimum."""
        replica._failed_over = True
        self._collect_replica(replica)
        orphans = replica.sched.drain_unfinished()
        self._affinity = {
            k: v for k, v in self._affinity.items() if v is not replica
        }
        if (
            self.replica_factory is not None
            and len(self.healthy_replicas()) < self.min_replicas
            and len(self.replicas) < self.max_replicas + 1
        ):
            self._spawn()
            self.scale_events.append((self.ticks, "heal", len(self.replicas)))
        for request in orphans:
            submitted0 = getattr(request, "submitted_s", None)
            try:
                target = self.route(request)
            except RuntimeError as exc:
                request.error = RuntimeError(
                    f"replica {replica.name} failed mid-flight "
                    f"({replica.error!r}) and no healthy replica remains"
                )
                request.error.__cause__ = exc
                request.done = True
                request.finished_s = time.perf_counter()
                self.failed.append(request)
                continue
            reset = getattr(target.runner, "reset", None)
            if reset is not None:
                reset(request)
            target.routed += 1
            target.sched.submit(request)
            if submitted0 is not None:
                # end-to-end latency counts from the FIRST submission
                request.submitted_s = submitted0
            self.rerouted += 1

    def _autoscale(self) -> None:
        if self.replica_factory is None or self.scale_up_backlog is None:
            return
        pool = self.healthy_replicas()
        if not pool:
            return
        backlog_per_replica = sum(r.pending() for r in pool) / len(pool)
        if (
            backlog_per_replica > self.scale_up_backlog
            and len(pool) < self.max_replicas
        ):
            self._spawn()
            self.scale_events.append((self.ticks, "up", len(self.replicas)))
        elif (
            backlog_per_replica <= self.scale_down_backlog
            and len(pool) > self.min_replicas
        ):
            idle = [r for r in pool if r.pending() == 0]
            if idle:
                self._retire(idle[-1])
                self.scale_events.append(
                    (self.ticks, "down", len(self.replicas))
                )


@dataclasses.dataclass
class OpenLoopReport:
    """Result of one open-loop pass: virtual-clock throughput + latency."""

    n_served: int
    n_failed: int
    makespan_s: float
    latencies_s: list  # sorted, per served request: finish - arrival
    ticks: int

    @property
    def scen_per_s(self) -> float:
        return self.n_served / self.makespan_s if self.makespan_s > 0 else 0.0

    def percentile(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        i = min(len(self.latencies_s) - 1, int(len(self.latencies_s) * q))
        return self.latencies_s[i]


def serve_open_loop(
    gateway: Gateway,
    requests: Sequence,
    arrivals_s: Sequence[float],
    *,
    per_replica_executors: bool = True,
    max_ticks: int = 100000,
) -> OpenLoopReport:
    """Drive an open-loop arrival schedule through the fleet on a measured
    event clock (see module docstring). ``arrivals_s`` are nondecreasing
    arrival offsets, one per request; arrivals never wait for completions.
    Every tick executes the real scheduler/runner and its measured wall
    time advances the owning executor's clock — one executor per replica
    (deployment model) or one shared executor (this host)."""
    if len(requests) != len(arrivals_s):
        raise ValueError(
            f"{len(requests)} requests vs {len(arrivals_s)} arrival times"
        )
    if any(b < a for a, b in zip(arrivals_s, arrivals_s[1:])):
        raise ValueError("arrivals_s must be nondecreasing")
    free_at: dict = {}
    shared_free = 0.0  # single-executor timeline
    last_ticked: dict = {}  # fairness tie-break when starts are equal
    i = 0
    n = len(requests)
    finish_times: list = []
    ticks = 0

    def start_of(replica) -> float:
        if per_replica_executors:
            return free_at.get(id(replica), 0.0)
        return shared_free

    while ticks < max_ticks:
        pool = [
            r for r in gateway.replicas if r.healthy and r.sched.has_work()
        ]
        next_tick = min(
            (
                (start_of(r), last_ticked.get(id(r), -1), r.index, r)
                for r in pool
            ),
            default=None,
        )
        if i < n and (next_tick is None or arrivals_s[i] <= next_tick[0]):
            t_arr = arrivals_s[i]
            request = requests[i]
            request._arrived_v = t_arr
            try:
                target = gateway.submit(request)
            except RuntimeError as exc:  # no healthy replica at all
                request.error = exc
                request.done = True
                request._finished_v = t_arr
                gateway.failed.append(request)
                i += 1
                continue
            # an executor that went idle before the arrival can only start
            # again at the arrival; a busy one keeps its own timeline
            if per_replica_executors:
                free_at[id(target)] = max(start_of(target), t_arr)
            else:
                shared_free = max(shared_free, t_arr)
            i += 1
            continue
        if next_tick is None:
            break  # no arrivals left, fleet drained (or all replicas dead)
        t0, _, _, replica = next_tick
        last_ticked[id(replica)] = ticks
        sched = replica.sched
        before_f, before_x = len(sched.finished), len(sched.failed)
        wall0 = time.perf_counter()
        gateway.tick_replica(replica)
        service_s = time.perf_counter() - wall0
        t_end = t0 + service_s
        if per_replica_executors:
            free_at[id(replica)] = t_end
        else:
            shared_free = t_end
        for request in (
            list(sched.finished[before_f:]) + list(sched.failed[before_x:])
        ):
            request._finished_v = t_end
            finish_times.append(t_end)
        ticks += 1

    latencies = sorted(
        r._finished_v - r._arrived_v
        for r in requests
        if getattr(r, "_finished_v", None) is not None
        and getattr(r, "error", None) is None
    )
    n_failed = sum(1 for r in requests if getattr(r, "error", None) is not None)
    makespan = max(finish_times) - min(arrivals_s) if finish_times else 0.0
    return OpenLoopReport(
        n_served=len(latencies),
        n_failed=n_failed,
        makespan_s=makespan,
        latencies_s=latencies,
        ticks=ticks,
    )
