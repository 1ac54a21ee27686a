"""The port's copy of the cloud batch layer (``repro_torch.cloud``).

The cases of ``tests/test_cloud.py`` on the port's copy, with the
straggler made certain (the first run of task 0 waits for its backup to
start) in place of the reference's sleep, so no case depends on a host's
timing; the simulated pool against the reference's bit for bit. Then what
the port changed: the process backend spawns its workers, which run torch
tasks after the parent has used torch and run one CPU thread each, and no
pool thread is alive or writing once ``shutdown()`` returns.
"""
import os
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro.cloud import SimBackend as JSimBackend
from repro.cloud import SimConfig as JSimConfig
from repro_torch.cloud import (
    BatchPool, BlobRef, LocalProcessBackend, ObjectStore, SimBackend, SimConfig, ThreadBackend,
)
from repro_torch.data.pde.two_phase import simulate_task


def _add_ref(a, b):
    return a + b


class _Straggler:
    """Task 0's first run blocks until a second run of task 0 (the backup)
    has started, so the pool must speculate; every other run returns."""

    def __init__(self):
        self.runs = 0
        self.backup_started = threading.Event()
        self.lock = threading.Lock()

    def __call__(self, tag):
        if tag == 0:
            with self.lock:
                self.runs += 1
                first = self.runs == 1
            if first:
                self.backup_started.wait(timeout=60)
            else:
                self.backup_started.set()
        return tag


_STRAGGLERS = {}


def _straggler_task(key, tag):
    return _STRAGGLERS[key](tag)


def test_object_store_roundtrip_and_dedup():
    with tempfile.TemporaryDirectory() as d:
        store = ObjectStore(d)
        arr = np.arange(1000, dtype=np.float32)
        r1 = store.put(arr)
        r2 = store.put(arr)
        assert r1.key == r2.key  # content addressed
        np.testing.assert_array_equal(store.get(r1), arr)


def test_object_store_is_safe_across_threads():
    """Many threads putting and getting blobs at once (more than the
    host's cores, a short switch interval): every round trip is exact, and
    equal contents land in one blob. The reference's shared zstd contexts
    fail this now and then."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with tempfile.TemporaryDirectory() as d:
            store = ObjectStore(d)

            def roundtrip(i):
                arr = np.random.default_rng(i % 8).standard_normal(4096 + i % 8)
                ref = store.put(arr)
                return ref.key, bool(np.array_equal(store.get(ref), arr))

            with ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as ex:
                out = list(ex.map(roundtrip, range(400), timeout=120))
            assert all(ok for _, ok in out)
            assert len({key for key, _ in out}) == 8
            assert not [f for f in os.listdir(d) if ".tmp" in f]
    finally:
        sys.setswitchinterval(old)


def test_pool_map_and_broadcast():
    with tempfile.TemporaryDirectory() as d:
        pool = BatchPool(ThreadBackend(4), store_root=d, vm_type="E4s_v3", n_vms=4)
        big = pool.broadcast(np.ones(100))
        assert isinstance(big, BlobRef)
        out = pool.map(_add_ref, [(i, big) for i in range(6)])
        for i, o in enumerate(out):
            np.testing.assert_array_equal(o, i + np.ones(100))
        rep = pool.cost_report()
        assert rep["tasks"] == 6 and rep["usd"] >= 0
        pool.shutdown()


@pytest.fixture
def straggler():
    key = object()
    _STRAGGLERS[id(key)] = _Straggler()
    yield id(key)
    del _STRAGGLERS[id(key)]


def test_speculative_straggler_reuses_uploaded_arg_refs(straggler):
    """tests/test_cloud.py's two speculative cases: the results, and the
    backup task reusing the first submission's BlobRefs (no re-upload)."""
    with tempfile.TemporaryDirectory() as d:
        pool = BatchPool(ThreadBackend(6), store_root=d, n_vms=6)
        puts = []
        orig_put = pool.store.put
        pool.store.put = lambda obj: (puts.append(1), orig_put(obj))[1]
        out = pool.map(_straggler_task, [(straggler, i) for i in range(6)],
                       speculative=True, straggler_factor=3.0)
        pool.shutdown()
        assert out == list(range(6))
        rec = pool.records[0]
        assert rec.speculated and rec.arg_refs is not None
        assert _STRAGGLERS[straggler].runs == 2
        assert len(puts) == 12, len(puts)  # 2 args x 6 tasks, each uploaded once


def test_no_pool_thread_writes_after_shutdown(straggler):
    """Speculation leaves the losing run of task 0 still running when
    ``map`` returns; ``shutdown()`` waits for it, and afterwards no pool
    thread is alive, the store no longer changes and holds no temporary
    file."""
    with tempfile.TemporaryDirectory() as d:
        pool = BatchPool(ThreadBackend(6), store_root=f"{d}/blobs", n_vms=6)
        pool.map(_straggler_task, [(straggler, i) for i in range(6)], speculative=True,
                 straggler_factor=3.0)
        pool.shutdown()
        assert not [t for t in threading.enumerate() if t.name.startswith("batchpool")]

        def listing():
            return {os.path.join(r, f): os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(f"{d}/blobs") for f in fs}

        before = listing()
        time.sleep(0.2)
        assert listing() == before
        assert not [f for f in before if ".tmp" in os.path.basename(f)]


def test_sim_backend_is_the_reference():
    """The simulated Azure Batch pool: the same report as the reference's
    for the same seed, with and without spot preemption."""
    for cfg_kw, job in (({}, (1024, 64, 60.0)), ({"spot": True, "spot_preempt_per_hour": 2.0,
                                                  "seed": 1}, (50, 10, 1800.0))):
        got = SimBackend(SimConfig(**cfg_kw)).run_job(*job)
        ref = JSimBackend(JSimConfig(**cfg_kw)).run_job(*job)
        assert got.__dict__ == ref.__dict__


def test_sim_submission_linear():
    """Paper Fig. 4a: submission time ~linear in tasks; ~16s @ 1024 tasks."""
    sim = SimBackend(SimConfig())
    t64 = sim.run_job(64, 64, 60.0).submit_time_s
    t1024 = sim.run_job(1024, 64, 60.0).submit_time_s
    assert t1024 > t64
    assert 10.0 < t1024 < 25.0
    t2048 = sim.run_job(2048, 64, 60.0).submit_time_s
    np.testing.assert_allclose(t2048 - t1024, t1024 - sim.cfg.submit_base_s, rtol=0.1)


def test_sim_weak_scaling_paper_metric():
    """Paper Fig. 4b: >=99% for both workloads at paper scale."""
    sim = SimBackend(SimConfig())
    ns = sim.run_job(3200, 1000, 15 * 60.0)
    co2 = sim.run_job(1600, 1000, 6.8 * 3600.0)
    assert ns.weak_scaling_efficiency(15 * 60.0) > 0.98
    assert co2.weak_scaling_efficiency(6.8 * 3600.0) > 0.99
    assert co2.end_to_end_efficiency(6.8 * 3600.0) < 1.0


def test_sim_spot_preemption_retries():
    sim = SimBackend(SimConfig(spot=True, spot_preempt_per_hour=2.0, seed=1))
    rep = sim.run_job(50, 10, 1800.0)
    assert rep.preemptions > 0
    assert len(rep.task_end_times) == 50
    assert rep.total_core_seconds > 50 * 1800.0


def test_array_store_parallel_write_pattern():
    """Disjoint chunk writes from multiple 'tasks' + partial reads."""
    from repro_torch.data.store import ArrayStore

    with tempfile.TemporaryDirectory() as d:
        st = ArrayStore.create(f"{d}/arr", (4, 8, 8), "f4", (1, 8, 8))
        for i in range(4):
            st.write_chunk((i, 0, 0), np.full((1, 8, 8), i, np.float32))
        assert st.n_complete() == 4
        got = ArrayStore.open(f"{d}/arr").read_slice((slice(1, 3), slice(2, 6), slice(0, 8)))
        assert got.shape == (2, 4, 8)
        np.testing.assert_array_equal(got[0], np.full((4, 8), 1))
        np.testing.assert_array_equal(got[1], np.full((4, 8), 2))


def test_process_backend_spawns_one_thread_workers_that_run_torch():
    """The parent has used torch (as the online trainer has, on the card);
    spawned workers still run a torch simulation, each on one CPU thread,
    and return numpy."""
    torch.ones(2).add_(1)
    with tempfile.TemporaryDirectory() as d:
        backend = LocalProcessBackend(2)
        assert backend._pool._mp_context.get_start_method() == "spawn"
        pool = BatchPool(backend, store_root=d, n_vms=2)
        try:
            threads = pool.map(torch.get_num_threads, [() for _ in range(2)])
            (mask, sat), = pool.map(simulate_task, [(0, 1, (8, 8, 4), 1, "cpu")])
        finally:
            pool.shutdown()
    assert threads == [1, 1]
    assert isinstance(sat, np.ndarray) and sat.shape == (8, 8, 4, 1)
    np.testing.assert_array_equal(sat, simulate_task(0, 1, (8, 8, 4), 1, "cpu")[1])
