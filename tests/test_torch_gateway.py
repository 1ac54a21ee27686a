"""The port's gateway against the JAX package's, on the CPU.

The same traffic of a plain runner (each request needs some steps; a
replica may break after a number of steps) goes through
``repro.serve.Gateway`` and the port's ``Gateway`` under each policy: with
failover, with no healthy replica left, with autoscaling and with the
factory healing a broken replica. The port must make the reference's
decisions: the requests each replica was routed, the re-routes, the scale
events, and the order in which requests finished or failed.

Then the FNO fleet: a one-replica gateway is bitwise the port's lone
scheduler; a two-replica fleet (one fixed bucket, two geomodels) is
bitwise a single port runner and within rtol 1e-4, atol 1e-5 of the JAX
fleet, under each policy. ``serve_open_loop`` refuses what the reference
refuses, and its event clock, read from a counter the runners advance
rather than from the host's clock, overlaps two replicas' ticks exactly as
the reference's does, however loaded the machine is.
"""
import types

import jax
import numpy as np
import pytest

from repro import serve as jserve
from repro.core import fno as jfno
from repro.core.partition import make_mesh
from repro.data.loader import Normalizer as JNormalizer
from repro.serve import gateway as jgateway
from repro_torch import serve as tserve
from repro_torch.core import fno as tfno
from repro_torch.data.loader import Normalizer
from repro_torch.serve import gateway as tgateway

TOL = dict(rtol=1e-4, atol=1e-5)
PACKAGES = {"jax": jserve, "port": tserve}
CFG = dict(grid=(16, 8, 8, 8), modes=(4, 2, 2, 3), width=8, in_channels=2, n_blocks=2,
           decoder_dim=8)
STATS = {"mean": [0.1, 0.0], "std": [0.8, 1.0]}
BUCKET = 2


class DummyRunner:
    """A plain runner: each request needs ``work`` steps; it raises out of
    ``step`` after ``break_after`` calls (the failover trigger). A step
    advances ``clock`` (when given) by ``tick_s``, the event clock's
    service time. ``affinity_key`` is the request's ``key``."""

    def __init__(self, work=1, break_after=None, max_slots=4, clock=None, tick_s=1.0):
        self.work, self.break_after, self.max_slots = work, break_after, max_slots
        self.clock, self.tick_s = clock, tick_s
        self.calls = 0
        self._left = {}

    def admit(self, slot, request):
        self._left[slot] = getattr(request, "work", self.work)

    def step(self, slots, active):
        self.calls += 1
        if self.break_after is not None and self.calls > self.break_after:
            raise RuntimeError("replica hardware gone")
        if self.clock is not None:
            self.clock[0] += self.tick_s
        done = []
        for i in active:
            self._left[i] -= 1
            if self._left[i] <= 0:
                done.append(i)
        return done

    def retire(self, slot, request):
        self._left.pop(slot, None)

    def reset(self, request):
        request.done = False
        request.error = None

    def affinity_key(self, request):
        return getattr(request, "key", None)


class Req:
    def __init__(self, rid, work=1, key=None):
        self.rid, self.work, self.key = rid, work, key
        self.done, self.error = False, None


def _traffic(n=12):
    """Requests of 1-3 steps, a third of them keyless, the rest on 3 keys."""
    return [Req(i, work=1 + i % 3, key=None if i % 3 == 0 else f"geo{i % 4}")
            for i in range(n)]


# traffic -> (gateway keyword arguments, runners' arguments or None for a
# factory, the factory's runner arguments)
TRAFFIC = {
    "steady": (dict(max_slots=2), [dict(), dict(work=2), dict()], None),
    "failover": (dict(max_slots=2), [dict(work=2, break_after=1), dict(work=2)], None),
    "no_healthy": (dict(max_slots=2), [dict(work=2, break_after=1)], None),
    "autoscale": (dict(min_replicas=1, max_replicas=3, scale_up_backlog=3,
                       scale_down_backlog=0, max_slots=2), None, dict(work=3, max_slots=2)),
    "heal": (dict(min_replicas=2, max_replicas=3, max_slots=2),
             [dict(work=2, break_after=2), dict(work=2)], dict(work=2, max_slots=2)),
}


def _drive(pkg, policy, traffic) -> dict:
    """Serve ``_traffic()`` through ``pkg``'s gateway; what it decided."""
    gw_kw, runner_kws, factory_kw = TRAFFIC[traffic]
    factory = None if factory_kw is None else (lambda: DummyRunner(**factory_kw))
    runners = None if runner_kws is None else [DummyRunner(**kw) for kw in runner_kws]
    gw = pkg.Gateway(runners, policy=policy, replica_factory=factory, **gw_kw)
    for r in _traffic():
        gw.submit(r)
    gw.run_until_done(max_steps=200)
    after = None
    try:
        gw.submit(Req(99))
    except RuntimeError as e:
        after = str(e).split(" (")[0]
    return {
        "routed": [(h.name, h.routed, h.healthy) for h in gw.replicas + gw.retired],
        "rerouted": gw.rerouted,
        "scale_events": list(gw.scale_events),
        "finished": [r.rid for r in gw.finished],
        "failed": [r.rid for r in gw.failed],
        "ticks": gw.ticks,
        "submit_after": after,
    }


@pytest.mark.parametrize("traffic", list(TRAFFIC))
@pytest.mark.parametrize("policy", tserve.POLICIES)
def test_gateway_decides_as_the_reference(policy, traffic):
    assert tserve.POLICIES == jserve.POLICIES
    want = _drive(jserve, policy, traffic)
    got = _drive(tserve, policy, traffic)
    assert got == want
    served = set(got["finished"]) | set(got["failed"])
    assert served >= set(range(12))
    if traffic == "failover":
        assert got["rerouted"] > 0 and not got["failed"]
    elif traffic == "no_healthy":
        assert got["submit_after"] == "no healthy replicas" and got["failed"]
        assert len(got["finished"]) + len(got["failed"]) == 12
    elif traffic == "autoscale":
        kinds = {k for _, k, _ in got["scale_events"]}
        assert {"up", "down"} <= kinds
    elif traffic == "heal":
        assert [k for _, k, _ in got["scale_events"]] == ["heal"] and not got["failed"]


@pytest.mark.parametrize("pkg", list(PACKAGES))
def test_duplicate_runner_instances_rejected(pkg):
    r = DummyRunner()
    with pytest.raises(ValueError, match="own runner instance"):
        PACKAGES[pkg].Gateway([r, r])


@pytest.mark.parametrize("requests,arrivals,words", [
    (2, [1.0, 0.5], "nondecreasing"), (1, [0.0, 1.0], "arrival times")])
def test_serve_open_loop_refuses_as_the_reference(requests, arrivals, words):
    for pkg in PACKAGES.values():
        gw = pkg.Gateway([DummyRunner()])
        with pytest.raises(ValueError, match=words):
            pkg.serve_open_loop(gw, [Req(i) for i in range(requests)], arrivals)


@pytest.mark.parametrize("n_replicas,per_replica,makespan", [
    (1, True, 8.0), (2, True, 4.0), (2, False, 8.0)], ids=["one", "two", "two_one_host"])
def test_serve_open_loop_event_clock_overlaps_replicas(monkeypatch, n_replicas, per_replica,
                                                       makespan):
    """Eight requests of one step each arrive at once. Every tick advances
    the event clock by exactly 1 s (the runners advance the counter the
    gateway reads as its clock), so the makespans are exact: one replica
    8 s, two with an executor each 4 s, two on one shared executor 8 s."""
    reports = {}
    for name, (pkg, module) in {"jax": (jserve, jgateway), "port": (tserve, tgateway)}.items():
        clock = [0.0]
        monkeypatch.setattr(module, "time", types.SimpleNamespace(perf_counter=lambda: clock[0]))
        runners = [DummyRunner(max_slots=1, clock=clock) for _ in range(n_replicas)]
        gw = pkg.Gateway(runners, policy="least-pending")
        reports[name] = pkg.serve_open_loop(gw, [Req(i) for i in range(8)], [0.0] * 8,
                                            per_replica_executors=per_replica)
    got, want = reports["port"], reports["jax"]
    assert got.n_served == 8 and got.n_failed == 0
    assert got.makespan_s == want.makespan_s == makespan
    assert got.latencies_s == want.latencies_s and got.ticks == want.ticks
    assert got.scen_per_s == want.scen_per_s and got.percentile(0.5) == want.percentile(0.5)


# ---------------------------------------------------------------------------
# The FNO fleet
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    jcfg = jfno.FNOConfig(**CFG)
    return jax.device_get(jfno.init_params(jax.random.PRNGKey(7), jcfg))


def _port_runner(params, n_static=1):
    return tserve.FNORunner(
        tfno.FNOConfig(**CFG), tfno.params_from_numpy(params, "cpu"), device="cpu",
        max_slots=BUCKET, buckets=(BUCKET,),
        x_normalizer=Normalizer.from_stats(STATS, "meanstd"),
        y_normalizer=Normalizer.from_stats({k: v[:1] for k, v in STATS.items()}, "meanstd"),
        n_static=n_static)


def _jax_runner(params, n_static=1):
    return jserve.FNORunner(
        jfno.FNOConfig(**CFG), params, mesh=make_mesh((1,), ("data",)), model_axis=None,
        max_slots=BUCKET, buckets=(BUCKET,),
        x_normalizer=JNormalizer.from_stats(STATS, "meanstd"),
        y_normalizer=JNormalizer.from_stats({k: v[:1] for k, v in STATS.items()}, "meanstd"),
        n_static=n_static)


def _xs(n: int) -> list:
    """Request i on geomodel i % 2, its dynamic channel its own; the last
    two byte-identical duplicates of the first two."""
    out = []
    for i in range(n):
        rng = np.random.default_rng(1000 + i)
        x = rng.normal(size=(CFG["in_channels"],) + CFG["grid"]).astype(np.float32)
        x[0] = np.random.default_rng(5000 + i % 2).normal(size=CFG["grid"]).astype(np.float32)
        out.append(x)
    return out + [out[0].copy(), out[1].copy()]


def _requests(pkg, xs, steps=2):
    return [pkg.ScenarioRequest(rid=i, x=x.copy(), steps=steps) for i, x in enumerate(xs)]


def _serve_single(pkg, runner, xs):
    sched = pkg.Scheduler(runner, BUCKET)
    reqs = _requests(pkg, xs)
    for r in reqs:
        sched.submit(r)
    sched.run_until_done(max_steps=100)
    assert not sched.failed
    return reqs, sched


def _serve_fleet(pkg, runners, xs, policy="least-pending"):
    gw = pkg.Gateway(runners, policy=policy)
    reqs = _requests(pkg, xs)
    for r in reqs:
        gw.submit(r)
    gw.run_until_done(max_steps=100)
    assert not gw.failed and all(r.done and r.error is None for r in reqs)
    return reqs, gw


@pytest.mark.parametrize("n_static", [0, 1], ids=["plain", "ensemble"])
def test_single_replica_gateway_bitwise_equal_to_the_scheduler(params, n_static):
    xs = _xs(6)
    runner = _port_runner(params, n_static)
    ref, sched = _serve_single(tserve, runner, xs)
    got, gw = _serve_fleet(tserve, [runner], xs)
    assert gw.ticks == sched.steps
    for a, b in zip(ref, got):
        assert len(a.outputs) == len(b.outputs) == 2
        for ya, yb in zip(a.outputs, b.outputs):
            np.testing.assert_array_equal(ya, yb)


@pytest.mark.parametrize("policy", tserve.POLICIES)
def test_two_replica_fleet_matches_jax_fleet_and_a_single_runner(params, policy):
    """Same parameters on every replica and one fixed bucket: which replica
    served a scenario is invisible in its bits. Under affinity the two
    geomodels are pinned to different replicas, the duplicates dedup on
    them, and the fleet's hit-rate is the single runner's."""
    xs = _xs(8)
    single = _port_runner(params)
    ref, _ = _serve_single(tserve, single, xs)
    got, gw = _serve_fleet(tserve, [_port_runner(params), _port_runner(params)], xs, policy)
    want, jgw = _serve_fleet(jserve, [_jax_runner(params), _jax_runner(params)], xs, policy)
    assert [h.routed for h in gw.replicas] == [h.routed for h in jgw.replicas]
    fleet, jfleet = gw.stats()["fleet"], jgw.stats()["fleet"]
    for key in ("cache_hits", "cache_misses", "dedup_attached", "ticks"):
        assert fleet[key] == jfleet[key], key
    for a, b, w in zip(ref, got, want):
        assert len(a.outputs) == len(b.outputs) == len(w.outputs) == 2
        for ya, yb, yw in zip(a.outputs, b.outputs, w.outputs):
            np.testing.assert_array_equal(yb, ya)
            np.testing.assert_allclose(yb, yw, **TOL)
    if policy == "affinity":
        keys = {_port_runner(params).affinity_key(r) for r in got}
        assert len(keys) == 2
        assert [h.routed for h in gw.replicas] == [5, 5]
        assert fleet["dedup_attached"] == 2
        assert fleet["cache_hit_rate"] == pytest.approx(single.cache.stats["hit_rate"], abs=0.05)


def test_affinity_key_and_reset_as_the_reference(params):
    xs = _xs(2)
    trunner, jrunner = _port_runner(params), _jax_runner(params)
    for x in xs:
        t, j = tserve.ScenarioRequest(rid=0, x=x), jserve.ScenarioRequest(rid=0, x=x)
        assert trunner.affinity_key(t) == jrunner.affinity_key(j) is not None
    bad = tserve.ScenarioRequest(rid=1, x=np.zeros((2, 3), np.float32))
    assert trunner.affinity_key(bad) is None
    assert _port_runner(params, n_static=0).affinity_key(bad) is None
    req = tserve.ScenarioRequest(rid=2, x=xs[0], outputs=[np.ones(1)], done=True,
                                 error=RuntimeError("x"))
    trunner.reset(req)
    assert req.outputs == [] and not req.done and req.error is None


def test_link_replicas_on_one_device(params):
    """On one device a link only numbers the replicas: the fleet serves as
    an unlinked one, bitwise. A runner cannot be linked twice in a fleet."""
    xs = _xs(4)
    want, _ = _serve_fleet(tserve, [_port_runner(params), _port_runner(params)], xs)
    runners = [_port_runner(params), _port_runner(params)]
    tserve.link_replicas(runners)
    assert [r.replica for r in runners] == [0, 1]
    got, _ = _serve_fleet(tserve, runners, xs)
    for a, b in zip(want, got):
        for ya, yb in zip(a.outputs, b.outputs):
            np.testing.assert_array_equal(ya, yb)
    with pytest.raises(ValueError, match="own runner instance"):
        tserve.link_replicas([runners[0], runners[0]])


def test_runners_are_freed_when_dropped(params):
    """A runner, linked or not, holds no reference to itself or to another
    runner: dropping the last reference frees it (and its weights) at once,
    with no garbage collection, as the rank code that frees one layout's
    weights before the next relies on."""
    import gc
    import weakref

    gc.disable()
    try:
        alone = _port_runner(params)
        linked = [_port_runner(params), _port_runner(params)]
        tserve.link_replicas(linked)
        refs = [weakref.ref(r) for r in [alone] + linked]
        del alone, linked
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()

