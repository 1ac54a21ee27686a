"""The port's datagen CLI vs the JAX package's, on the CPU.

The same arguments through both (``--backend thread``, the port with
``--device cpu``): two-phase ``--n 4 --grid 16 8 8 --nt 4`` with and
without ``--geomodel``, and Navier-Stokes at n = 16. The x stores bit for
bit, the y stores within the simulators' gates (two-phase saturation
atol 1e-4; vorticity 1e-5 of its max|ref|), the persisted stats within
1e-4 relative, the ``gen`` signature and normalizer kind identical. Then
the reference's own datagen cases (``tests/test_streaming.py``) on the
port: ``--resume`` simulates nothing and leaves the stats bit for bit,
the stale-chunk and signature-mismatch refusals in the reference's words,
and the incremental stats persisted before the run ends.

The reference's runs take its zstd contexts one thread at a time
(``_one_thread_at_a_time``): its object store and chunk store share one
compressor and one decompressor between the pool's threads, which
zstandard does not allow (ROADMAP Queue 3, a reference fault the port
does not copy), and a run on two threads fails with "Data corruption
detected" now and then.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

import repro.cloud.objectstore as jobjectstore
import repro.data.store as jstore
from repro.launch import datagen as jdatagen
from repro_torch.data.store import ArrayStore
from repro_torch.launch import datagen as tdatagen

COMMON = ["--n", "4", "--nt", "4", "--backend", "thread", "--workers", "2"]
RUNS = {
    "two_phase": ["--pde", "two_phase", "--grid", "16", "8", "8"],
    "two_phase_geomodel": ["--pde", "two_phase", "--grid", "16", "8", "8", "--geomodel"],
    "navier_stokes": ["--pde", "navier_stokes", "--grid", "16", "16", "16"],
}
SAT_ATOL, VORT_RTOL_OF_MAX, STATS_RTOL = 1e-4, 1e-5, 1e-4


class _Locked:
    """A zstd context used by one thread at a time."""

    def __init__(self, ctx):
        self.ctx, self.lock = ctx, threading.Lock()

    def compress(self, b):
        with self.lock:
            return self.ctx.compress(b)

    def decompress(self, b):
        with self.lock:
            return self.ctx.decompress(b)


def _one_thread_at_a_time(mp: pytest.MonkeyPatch) -> None:
    for module in (jobjectstore, jstore):
        for name in ("_C", "_D"):
            if getattr(module, name, None) is not None:
                mp.setattr(module, name, _Locked(getattr(module, name)))


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    root = tmp_path_factory.mktemp("datagen")
    out, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)  # tiny grids: one intra-op thread per task is faster
    try:
        with pytest.MonkeyPatch.context() as mp:
            _one_thread_at_a_time(mp)
            for name, flags in RUNS.items():
                ours, ref = str(root / f"{name}_torch"), str(root / f"{name}_jax")
                assert tdatagen.main(flags + COMMON + ["--out", ours, "--device", "cpu"]) == 4
                assert jdatagen.main(flags + COMMON + ["--out", ref]) == 4
                out[name] = (ours, ref)
    finally:
        torch.set_num_threads(threads)
    return out


def _samples(root):
    store = ArrayStore.open(root)
    rest = tuple(slice(0, d) for d in store.shape[1:])
    return store, np.stack([store.read_slice((slice(i, i + 1),) + rest)[0]
                            for i in range(store.shape[0])])


@pytest.mark.parametrize("run", RUNS)
def test_x_store_is_bitwise_the_reference(generated, run):
    ours, ref = generated[run]
    (xs, x), (jxs, jx) = _samples(f"{ours}/x"), _samples(f"{ref}/x")
    assert xs.shape == jxs.shape and xs.chunks == jxs.chunks
    np.testing.assert_array_equal(x, jx)


@pytest.mark.parametrize("run", RUNS)
def test_y_store_within_the_simulator_gate(generated, run):
    ours, ref = generated[run]
    (ys, y), (jys, jy) = _samples(f"{ours}/y"), _samples(f"{ref}/y")
    assert ys.shape == jys.shape and ys.chunks == jys.chunks
    atol = (VORT_RTOL_OF_MAX * float(np.abs(jy).max()) if run == "navier_stokes"
            else SAT_ATOL)
    np.testing.assert_allclose(y, jy, rtol=0, atol=atol)


@pytest.mark.parametrize("run", RUNS)
def test_stats_and_signature_are_the_reference(generated, run):
    ours, ref = generated[run]
    for name in ("x", "y"):
        mine, theirs = ArrayStore.open(f"{ours}/{name}").meta, ArrayStore.open(f"{ref}/{name}").meta
        assert mine["gen"] == theirs["gen"]
        assert mine["normalizer"] == theirs["normalizer"]
        for key in ("count", "n_samples"):
            assert mine["stats"][key] == theirs["stats"][key]
        for key in ("mean", "std", "absmax"):
            np.testing.assert_allclose(mine["stats"][key], theirs["stats"][key],
                                       rtol=STATS_RTOL, atol=0)


def test_resume_simulates_nothing_and_keeps_the_stats(generated, capsys):
    ours, _ = generated["two_phase"]
    metas = [open(os.path.join(ours, n, "meta.json")).read() for n in ("x", "y")]
    argv = RUNS["two_phase"] + COMMON + ["--out", ours, "--device", "cpu", "--resume"]
    assert tdatagen.main(argv) == 4
    assert "already complete, simulating 0 (two_phase)" in capsys.readouterr().out
    assert [open(os.path.join(ours, n, "meta.json")).read() for n in ("x", "y")] == metas


def test_open_or_create_refuses_stale_chunks(tmp_path):
    root = str(tmp_path / "x")
    store = ArrayStore.create(root, (2, 8), "f4", (1, 4))
    store.write_sample(0, np.ones(8, np.float32))
    with pytest.raises(SystemExit, match="chunk file"):
        tdatagen.open_or_create(root, (2, 8), (1, 4), resume=False)
    assert tdatagen.open_or_create(root, (2, 8), (1, 4), resume=True).sample_complete(0)
    empty = str(tmp_path / "y")
    ArrayStore.create(empty, (2, 8), "f4", (1, 4))
    tdatagen.open_or_create(empty, (2, 8), (1, 4), resume=False)


def test_resume_refuses_a_mismatched_run_signature(tmp_path):
    argv = ["--pde", "two_phase", "--n", "2", "--grid", "8", "8", "4", "--nt", "2",
            "--out", str(tmp_path / "ds"), "--backend", "thread", "--workers", "2",
            "--resume", "--device", "cpu"]
    assert tdatagen.main(argv + ["--seed", "0"]) == 2
    with pytest.raises(SystemExit, match="refusing to mix"):
        tdatagen.main(argv + ["--seed", "1"])
    assert tdatagen.main(argv + ["--seed", "0"]) == 2


def test_incremental_stats_match_the_full_pass(tmp_path):
    out = str(tmp_path / "ds")
    tdatagen.main(["--pde", "two_phase", "--n", "5", "--grid", "8", "8", "4", "--nt", "2",
                   "--out", out, "--backend", "thread", "--workers", "2",
                   "--stats-every", "2", "--device", "cpu"])
    for name in ("x", "y"):
        store = ArrayStore.open(f"{out}/{name}")
        direct = tdatagen.compute_store_stats(store)
        np.testing.assert_allclose(store.meta["stats"]["mean"], direct["mean"], rtol=1e-6)
        np.testing.assert_allclose(store.meta["stats"]["std"], direct["std"], rtol=1e-5)
        assert store.meta["stats"]["n_samples"] == 5


def test_datagen_needs_a_card_or_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdatagen.main(["--n", "1", "--out", str(tmp_path / "ds")])
    assert not os.path.exists(tmp_path / "ds")


def test_stats_helpers_are_the_reference():
    """The Welford merge and the stats it persists, against the
    reference's on the same blocks."""
    rng = np.random.default_rng(3)
    blocks = [rng.standard_normal((1, 2, 4, 4, 2, 3)).astype(np.float32) * (i + 1)
              for i in range(3)]
    mine = theirs = None
    for b in blocks:
        mine = tdatagen.merge_sample_welford(mine, b[0])
        theirs = jdatagen.merge_sample_welford(theirs, b[0])
    assert json.dumps(tdatagen.stats_from_state(mine, 3)) == json.dumps(
        jdatagen.stats_from_state(theirs, 3))
