"""The port's fleet-shared geomodel cache store against the JAX package's,
on the CPU.

Every store case runs the same calls on both packages' stores (the shared
dict and the ``.npz`` file backend) and holds the port's answers and
counters to the reference's. Entries cross between the two packages'
``FileCacheStore``s field for field. Then ``FNORunner``'s store tier:
``cache_version`` namespaces as the reference's does, a runner that was
never warmed serves from the store without recomputing and bitwise as the
warmed one, and after the pinned replica fails the survivor hits the store
and serves the second wave bitwise as the first. Served outputs are held
to the JAX runner's at rtol 1e-4, atol 1e-5.
"""
import os

import jax
import numpy as np
import pytest

from repro import serve as jserve
from repro.core import fno as jfno
from repro.core.partition import make_mesh
from repro.data.loader import Normalizer as JNormalizer
from repro_torch import serve as tserve
from repro_torch.core import fno as tfno
from repro_torch.data.loader import Normalizer

TOL = dict(rtol=1e-4, atol=1e-5)
N_STATIC = 1
CFG = dict(grid=(16, 8, 8, 8), modes=(4, 2, 2, 3), width=8, in_channels=2, n_blocks=2,
           decoder_dim=8)
X_STATS = {"mean": [0.2, -0.4], "std": [0.7, 1.3]}
Y_STATS = {"mean": [0.1], "std": [0.8]}
BUCKET = 2
PACKAGES = {"jax": jserve, "port": tserve}


@pytest.fixture(scope="module")
def params():
    jcfg = jfno.FNOConfig(**CFG)
    return {seed: jax.device_get(jfno.init_params(jax.random.PRNGKey(seed), jcfg))
            for seed in (3, 9)}


def _arrays(seed: int, deep: bool = True) -> dict:
    rng = np.random.default_rng(seed)
    fields = {"normalized": rng.normal(size=(3, 4)).astype(np.float32),
              "prelift": rng.normal(size=(2, 4)).astype(np.float32)}
    if deep:
        spec = (rng.normal(size=(2, 3)) + 1j * rng.normal(size=(2, 3))).astype(np.complex64)
        fields.update(spectra=spec, contribution=(spec * 1.5).astype(np.complex64))
    return fields


def _entry(pkg, seed: int, deep: bool = True):
    """The same entry as ``pkg``'s ``GeomodelEntry``."""
    fields = _arrays(seed, deep)
    return pkg.GeomodelEntry(pkg.content_key(fields["normalized"]), fields["normalized"],
                             fields["prelift"], fields.get("spectra"),
                             fields.get("contribution"))


def _store(pkg, backend: str, root):
    return pkg.DictCacheStore() if backend == "dict" else pkg.FileCacheStore(str(root))


def _fields(entry) -> dict:
    return None if entry is None else {
        name: getattr(entry, name) for name in ("normalized", "prelift", "spectra",
                                                "contribution")}


def _same_fields(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name, w in want.items():
        g = got[name]
        if w is None:
            assert g is None, name
        else:
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def _on_both(backend, tmp_path, calls):
    """Run ``calls(pkg, store)`` on each package's store; return each
    package's (result, stats)."""
    out = {}
    for name, pkg in PACKAGES.items():
        store = _store(pkg, backend, tmp_path / name)
        out[name] = (calls(pkg, store), store.stats)
    return out


def _held(out):
    """The port's stats and fetched fields equal the reference's."""
    (jres, jstats), (tres, tstats) = out["jax"], out["port"]
    assert tstats == jstats
    assert len(tres) == len(jres)
    for t, j in zip(tres, jres):
        if j is None:
            assert t is None
        else:
            _same_fields(t, j)
    return tres, tstats


BACKENDS = ["dict", "file"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_roundtrip_full_and_shallow_entries(backend, tmp_path):
    def calls(pkg, store):
        full, shallow = _entry(pkg, 0), _entry(pkg, 1, deep=False)
        store.put("v1", full.key, full)
        store.put("v1", shallow.key, shallow)
        return [_fields(store.get("v1", full.key)), _fields(store.get("v1", shallow.key))]

    (full, shallow), stats = _held(_on_both(backend, tmp_path, calls))
    _same_fields(full, _fields(_entry(tserve, 0)))
    assert shallow["spectra"] is None and shallow["contribution"] is None
    assert stats["hits"] == 2 and stats["puts"] == 2 and stats["entries"] == 2
    assert stats["bytes"] > 0 and stats["hit_rate"] == 1.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_version_namespaces_are_isolated(backend, tmp_path):
    def calls(pkg, store):
        e = _entry(pkg, 2)
        store.put("ckpt-a", e.key, e)
        return [_fields(store.get("ckpt-b", e.key)), _fields(store.get("ckpt-a", e.key))]

    (other, same), stats = _held(_on_both(backend, tmp_path, calls))
    assert other is None and same is not None and stats["misses"] == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_store_never_downgrades_a_fuller_entry(backend, tmp_path):
    def calls(pkg, store):
        full, e2 = _entry(pkg, 3), _entry(pkg, 4)
        store.put("v", full.key, full)
        store.put("v", full.key, full.without_deep())  # ignored: shallower
        store.put("v", e2.key, e2.without_deep())
        store.put("v", e2.key, e2)  # a deeper put replaces a shallow entry
        return [_fields(store.get("v", full.key)), _fields(store.get("v", e2.key))]

    (full, e2), stats = _held(_on_both(backend, tmp_path, calls))
    assert full["contribution"] is not None and e2["contribution"] is not None
    assert stats["puts"] == 3


def test_dict_backend_stores_and_returns_copies(tmp_path):
    def calls(pkg, store):
        e = _entry(pkg, 5)
        store.put("v", e.key, e)
        e.normalized[:] = -1.0  # the caller's arrays, mutated after put
        got = store.get("v", e.key)
        first = _fields(got)
        first = {k: None if v is None else v.copy() for k, v in first.items()}
        got.normalized[:] = -2.0  # a returned array, mutated
        return [first, _fields(store.get("v", e.key))]

    (first, again), _ = _held(_on_both("dict", tmp_path, calls))
    want = _arrays(5)["normalized"]
    np.testing.assert_array_equal(first["normalized"], want)
    np.testing.assert_array_equal(again["normalized"], want)


def test_file_backend_corrupt_entry_is_miss_and_removed(tmp_path):
    removed = []

    def calls(pkg, store):
        e = _entry(pkg, 6)
        store.put("v", e.key, e)
        path = store._path("v", e.key)
        with open(path, "wb") as f:
            f.write(b"not an npz")
        miss = _fields(store.get("v", e.key))
        removed.append(not os.path.exists(path))
        store.put("v", e.key, e)  # a fresh put rewrites it
        return [miss, _fields(store.get("v", e.key))]

    (miss, again), stats = _held(_on_both("file", tmp_path, calls))
    assert miss is None and removed == [True, True] and again is not None
    assert stats["misses"] == 1 and stats["puts"] == 2


@pytest.mark.parametrize("spec", ["dict", "mem", "root"])
def test_open_cache_store_spec(spec, tmp_path):
    for name, pkg in PACKAGES.items():
        store = pkg.open_cache_store(str(tmp_path / name) if spec == "root" else spec)
        kind = pkg.FileCacheStore if spec == "root" else pkg.DictCacheStore
        assert isinstance(store, kind)
        if spec == "root":
            assert os.path.isdir(store.root)


@pytest.mark.parametrize("deep", [True, False], ids=["full", "shallow"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_npz_entries_cross_between_the_packages(writer, reader, deep, tmp_path):
    """One package's ``FileCacheStore`` reads the other's entries, field
    for field: the ``.npz`` layout is the same."""
    root = str(tmp_path / "shared")
    w, r = PACKAGES[writer], PACKAGES[reader]
    e = _entry(w, 7, deep)
    w.FileCacheStore(root).put("v", e.key, e)
    store = r.FileCacheStore(root)
    got = store.get("v", e.key)
    assert isinstance(got, r.GeomodelEntry) and got.key == e.key
    _same_fields(_fields(got), _fields(e))
    assert store.stats["entries"] == 1 and store.stats["hits"] == 1


# ---------------------------------------------------------------------------
# The runner's store tier
# ---------------------------------------------------------------------------

def _geomodel(seed: int) -> np.ndarray:
    return np.random.default_rng(5000 + seed).normal(size=(N_STATIC,) + CFG["grid"]).astype(
        np.float32)


def _xs(n: int, geo_seeds=(0,)) -> list:
    """``n`` raw inputs, request i on geomodel ``geo_seeds[i % len]``."""
    out = []
    for i in range(n):
        dyn = np.random.default_rng(1000 + i).normal(
            size=(CFG["in_channels"] - N_STATIC,) + CFG["grid"]).astype(np.float32)
        out.append(np.concatenate([_geomodel(geo_seeds[i % len(geo_seeds)]), dyn], axis=0))
    return out


def _port_runner(params, level="deep", store=None, x_stats=X_STATS):
    return tserve.FNORunner(
        tfno.FNOConfig(**CFG), tfno.params_from_numpy(params, "cpu"), device="cpu",
        max_slots=BUCKET, buckets=(BUCKET,),
        x_normalizer=Normalizer.from_stats(x_stats, "meanstd"),
        y_normalizer=Normalizer.from_stats(Y_STATS, "meanstd"),
        n_static=N_STATIC, cache=tserve.GeomodelCache(), cache_level=level, cache_store=store)


def _jax_runner(params, level="deep", store=None, x_stats=X_STATS):
    return jserve.FNORunner(
        jfno.FNOConfig(**CFG), params, mesh=make_mesh((1,), ("data",)), model_axis=None,
        max_slots=BUCKET, buckets=(BUCKET,),
        x_normalizer=JNormalizer.from_stats(x_stats, "meanstd"),
        y_normalizer=JNormalizer.from_stats(Y_STATS, "meanstd"),
        n_static=N_STATIC, cache=jserve.GeomodelCache(), cache_level=level, cache_store=store)


def _serve(pkg, runner, xs, steps=2) -> list:
    sched = pkg.Scheduler(runner, BUCKET)
    reqs = [pkg.ScenarioRequest(rid=i, x=x.copy(), steps=steps) for i, x in enumerate(xs)]
    for r in reqs:
        sched.submit(r)
    sched.run_until_done(max_steps=100)
    assert not sched.failed and all(r.done for r in reqs)
    return [r.outputs for r in reqs]


def _close_to(got: list, want: list):
    for g_steps, w_steps in zip(got, want):
        assert len(g_steps) == len(w_steps)
        for g, w in zip(g_steps, w_steps):
            np.testing.assert_allclose(g, w, **TOL)


def _bitwise(a: list, b: list):
    for a_steps, b_steps in zip(a, b):
        assert len(a_steps) == len(b_steps)
        for x, y in zip(a_steps, b_steps):
            np.testing.assert_array_equal(x, y)


# what differs between two runners; the port's versions must agree or
# differ exactly where the reference's do
VERSION_CASES = {
    "same": {},
    "level": {"level": "prelift"},
    "weights": {"seed": 9},
    "normalizer": {"x_stats": {"mean": [0.3, -0.4], "std": [0.7, 1.3]}},
}


@pytest.mark.parametrize("case", list(VERSION_CASES))
def test_cache_version_namespaces_as_the_reference(params, case):
    kw = dict(VERSION_CASES[case])
    seed = kw.pop("seed", 3)
    same = {}
    for name, make in (("jax", _jax_runner), ("port", _port_runner)):
        a, b = make(params[3]), make(params[seed], **kw)
        assert isinstance(a.cache_version, str) and len(a.cache_version) == 32
        same[name] = a.cache_version == b.cache_version
    assert same["port"] == same["jax"] == (case == "same")


class _NoEncode:
    """A static normalizer whose ``encode`` must not run: the runner holding
    it may only serve geomodels from a cache tier."""

    def __init__(self, norm):
        self.identity, self.mean, self.scale = norm.identity, norm.mean, norm.scale

    def encode(self, x):
        raise AssertionError("the geomodel prefix was recomputed")


def _no_recompute(runner):
    runner.cache_version  # noqa: B018 - computed from the real stats first
    runner._x_norm_static = _NoEncode(runner._x_norm_static)

    def refuse(*_):
        raise AssertionError("the spectral prefix was recomputed")

    runner._np_spectra = runner._np_contribution = refuse


@pytest.mark.parametrize("level", ["prelift", "deep"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_store_populates_local_cache_without_recompute(params, backend, level, tmp_path):
    """A runner that was never warmed serves from the store: no host
    recompute, its local cache filled from the store, outputs bitwise the
    warmed runner's and within the gate of the JAX runner's."""
    xs = _xs(3)
    store = _store(tserve, backend, tmp_path / "store")
    warmed = _port_runner(params[3], level, store)
    ref = _serve(tserve, warmed, xs)
    assert store.puts == 1 and store.hits == 0
    fresh = _port_runner(params[3], level, store)
    _no_recompute(fresh)
    got = _serve(tserve, fresh, xs)
    assert store.hits >= 1 and fresh.cache.stats["entries"] == 1
    _bitwise(got, ref)
    jstore = _store(jserve, backend, tmp_path / "jstore")
    _serve(jserve, _jax_runner(params[3], level, jstore), xs)
    want = _serve(jserve, _jax_runner(params[3], level, jstore), xs)
    assert jstore.stats["hits"] == store.stats["hits"]
    _close_to(got, want)


def _failover_wave(pkg, gw, xs):
    reqs = [pkg.ScenarioRequest(rid=i, x=x.copy(), steps=2) for i, x in enumerate(xs)]
    for r in reqs:
        gw.submit(r)
    gw.run_until_done(max_steps=200)
    assert all(r.done and r.error is None for r in reqs)
    return [r.outputs for r in reqs]


def _fleet_with_failover(pkg, make, params, store, xs):
    """Affinity pins the ensemble to one replica, which warms its cache and
    the store; that replica then dies, and the second wave is served by the
    survivor. Returns both waves and the gateway."""
    gw = pkg.Gateway([make(params, store=store), make(params, store=store)], policy="affinity")
    wave1 = _failover_wave(pkg, gw, xs)
    pinned = max(gw.replicas, key=lambda h: h.routed)
    other = next(h for h in gw.replicas if h is not pinned)
    assert other.routed == 0 and store.puts == 1

    def dead_step(slots, active):
        raise RuntimeError("simulated replica hardware failure")

    pinned.runner.step = dead_step
    wave2 = _failover_wave(pkg, gw, xs)
    assert not pinned.healthy and gw.rerouted > 0
    assert other.runner.cache.stats["entries"] == 1
    return wave1, wave2, gw


@pytest.mark.parametrize("backend", BACKENDS)
def test_store_keeps_geomodel_warm_across_replica_failover(params, backend, tmp_path):
    """After the pinned replica fails, the survivor's local cache is cold
    but its store lookup hits, and it serves the second wave bitwise as the
    first; both waves within the gate of the JAX fleet's."""
    xs = _xs(4)
    store = _store(tserve, backend, tmp_path / "fleet")
    wave1, wave2, gw = _fleet_with_failover(tserve, _port_runner, params[3], store, xs)
    assert store.hits >= 1, store.stats
    _bitwise(wave2, wave1)
    fleet = gw.stats()["fleet"]
    assert fleet["store"] is not None and fleet["store"]["hits"] >= 1
    assert fleet["cache_bytes"] > 0
    jstore = _store(jserve, backend, tmp_path / "jfleet")
    jwave1, jwave2, jgw = _fleet_with_failover(jserve, _jax_runner, params[3], jstore, xs)
    assert jgw.rerouted == gw.rerouted and jstore.stats["hits"] == store.stats["hits"]
    _close_to(wave1, jwave1)
    _close_to(wave2, jwave2)
