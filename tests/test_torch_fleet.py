"""The port's fleet serving over rank groups and its serving CLI's fleet,
against the JAX package, on the CPU.

One launch of 4 gloo ranks runs ``tests/torch_fleet_checks.py``: two
ranked ``FNORunner`` replicas over (1 data x 4 model) behind the port's
``Gateway``, at the deep and the prelift cache level, two geomodels and
byte-identical duplicates. This process holds each wave's outputs against
the serial port runner and the JAX one-device runner on the same requests
(rtol 1e-4, atol 1e-5), checks that every rank ran rank 0's ticks on each
replica (also after replica 0 raised on the controller before its header),
and that the survivor of that failure hit the shared store and served the
second wave bitwise as the first.

Then ``serve_pde --replicas 2 --policy affinity --cache-store DIR
--max-steps N --ensemble`` against the reference CLI's served outputs on
one checkpoint the JAX package wrote, the same fleet on 4 ranks against
the one-rank fleet, and, in the reference's words, the exit on a step
budget too small and the refusal of ``--replicas 0``.
"""
import json
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

import torch_fleet_checks as rank_side
from torch_dist_checks import one_launch_at_a_time
from repro import serve as jserve
from repro.core import fno as jfno
from repro.core.partition import make_mesh
from repro.data.loader import Normalizer as JNormalizer
from repro.launch import serve_pde as jserve_pde
from repro.train import checkpoint as jckpt
from repro_torch import serve as tserve
from repro_torch.core import fno as tfno
from repro_torch.data.loader import Normalizer
from repro_torch.launch import serve_pde
from repro_torch.launch.mesh import launch_ranks

TOL = dict(rtol=1e-4, atol=1e-5)
CFG = dict(grid=(16, 8, 8, 8), modes=(4, 2, 2, 3), width=8, in_channels=2, out_channels=1,
           n_blocks=2, decoder_dim=8)
STATS = {"x": {"mean": [0.2, -0.1], "std": [1.5, 0.7]}, "y": {"mean": [0.05], "std": [0.9]}}
TIMEOUT_S = 240


def _xs() -> list:
    """Four requests on two geomodels (i % 2), then duplicates of two."""
    out = []
    for i in range(4):
        x = np.random.default_rng(300 + i).standard_normal(
            (CFG["in_channels"],) + CFG["grid"]).astype(np.float32)
        x[0] = np.random.default_rng(7 + i % 2).standard_normal(CFG["grid"]).astype(np.float32)
        out.append(x)
    return out + [out[0].copy(), out[3].copy()]


def _served(pkg, runner, xs) -> list:
    sched = pkg.Scheduler(runner, rank_side.BUCKET)
    reqs = [pkg.ScenarioRequest(rid=i, x=x.copy(), steps=rank_side.SERVE_STEPS)
            for i, x in enumerate(xs)]
    for r in reqs:
        sched.submit(r)
    sched.run_until_done(max_steps=100)
    assert not sched.failed and all(r.done for r in reqs)
    return [r.outputs for r in reqs]


def _compare(got: list, want: list) -> dict:
    worst = 0.0
    for g_steps, w_steps in zip(got, want):
        if len(g_steps) != len(w_steps):
            return {"ok": False, "detail": f"{len(g_steps)} steps vs {len(w_steps)}"}
        for g, w in zip(g_steps, w_steps):
            g, w = np.asarray(g), np.asarray(w)
            try:
                np.testing.assert_allclose(g, w, **TOL)
            except AssertionError as e:
                return {"ok": False, "detail": str(e)}
            worst = max(worst, float(np.abs(g - w).max()))
    return {"ok": len(got) == len(want), "detail": f"max|d|={worst:.3e}"}


CHECKS = tuple(
    f"{name}_{what}" for name, _, _, fail in rank_side.FLEETS
    for what in ("vs_serial_port_runner", "vs_jax_runner", "every_rank_ran_rank_0s_ticks")
    + (("failover_rerouted_to_a_store_hit", "second_wave_bitwise_equal_to_the_first")
       if fail else ("replicas_shared_the_traffic",))
    + ("closed_fleet_refuses_ticks_and_links",))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet")
    params = jax.device_get(jfno.init_params(jax.random.PRNGKey(4), jfno.FNOConfig(**CFG)))
    xs = _xs()
    t0 = time.perf_counter()
    with one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_fleet_checks, 4, str(root),
                             args=(params, xs, CFG, STATS), deadline_s=TIMEOUT_S, device="cpu")
    launch_s = time.perf_counter() - t0
    out = {}
    served, ticks = ranks[0]["served"], ranks[0]["ticks"]
    for name, level, _, fail in rank_side.FLEETS:
        trunner = tserve.FNORunner(
            tfno.FNOConfig(**CFG), tfno.params_from_numpy(params, "cpu"), device="cpu",
            max_slots=rank_side.BUCKET, x_normalizer=Normalizer.from_stats(STATS["x"], "meanstd"),
            y_normalizer=Normalizer.from_stats(STATS["y"], "meanstd"),
            n_static=rank_side.N_STATIC, cache_level=level)
        jrunner = jserve.FNORunner(
            jfno.FNOConfig(**CFG), params, mesh=make_mesh((1,), ("data",)), model_axis=None,
            max_slots=rank_side.BUCKET,
            x_normalizer=JNormalizer.from_stats(STATS["x"], "meanstd"),
            y_normalizer=JNormalizer.from_stats(STATS["y"], "meanstd"),
            n_static=rank_side.N_STATIC, cache_level=level)
        fleet = served[name]
        for what, want in (("vs_serial_port_runner", _served(tserve, trunner, xs)),
                           ("vs_jax_runner", _served(jserve, jrunner, xs))):
            checks = [_compare([[t.numpy() for t in s] for s in wave], want)
                      for wave in fleet["waves"]]
            out[f"{name}_{what}"] = {"ok": all(c["ok"] for c in checks),
                                     "detail": "; ".join(c["detail"] for c in checks)}
        per_rank = [t[name] for t in ticks]
        out[f"{name}_every_rank_ran_rank_0s_ticks"] = {
            "ok": all(t == per_rank[0] for t in per_rank) and sum(per_rank[0]) > 0,
            "detail": f"ticks per replica on each rank: {per_rank}"}
        if fail:
            store = fleet["store"]
            out[f"{name}_failover_rerouted_to_a_store_hit"] = {
                "ok": (fleet["rerouted"] > 0 and fleet["healthy"] == [False, True]
                       and store["hits"] >= 1 and fleet["survivor_entries"] == 2
                       and fleet["routed_first_wave"] == [3, 3]),
                "detail": json.dumps({k: fleet[k] for k in (
                    "routed_first_wave", "routed", "healthy", "rerouted", "store",
                    "survivor_entries")})}
            first, second = fleet["waves"]
            same = all(torch.equal(a, b) for s1, s2 in zip(first, second)
                       for a, b in zip(s1, s2))
            out[f"{name}_second_wave_bitwise_equal_to_the_first"] = {
                "ok": same, "detail": f"bitwise {same}"}
        else:
            out[f"{name}_replicas_shared_the_traffic"] = {
                "ok": all(n > 0 for n in fleet["routed"]) and all(n > 0 for n in per_rank[0]),
                "detail": f"routed {fleet['routed']}, ticks {per_rank[0]}"}
        refusals = fleet["refusals"]
        out[f"{name}_closed_fleet_refuses_ticks_and_links"] = {
            "ok": len(refusals) == 2 and "were stopped" in refusals[0]
            and "closed runner" in refusals[1], "detail": "; ".join(refusals)}
    out["launch_seconds"] = launch_s
    path = root / "checks.json"
    path.write_text(json.dumps(out, indent=1))
    return path


@pytest.mark.parametrize("check", CHECKS)
def test_fleet_check(results, check):
    entry = json.loads(results.read_text()).get(check)
    assert entry is not None, f"{check} was not run"
    assert entry["ok"], entry["detail"]


# ---------------------------------------------------------------------------
# The serving CLI's fleet
# ---------------------------------------------------------------------------

FLEET_FLAGS = ["--replicas", "2", "--policy", "affinity", "--max-steps", "50", "--ensemble",
               "--scenarios", "4", "--max-batch", "2", "--rollout-steps", "2", "--dup", "2"]


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint the JAX package wrote, with its serving config."""
    d = str(tmp_path_factory.mktemp("fleet_cli") / "ck")
    jcfg = jfno.FNOConfig(**CFG)
    jckpt.save(d, 0, {"params": jfno.init_params(jax.random.PRNGKey(0), jcfg)})
    with open(os.path.join(d, "fno_config.json"), "w") as f:
        json.dump({"grid": list(jcfg.grid), "modes": list(jcfg.modes), "width": jcfg.width,
                   "in_channels": jcfg.in_channels, "out_channels": jcfg.out_channels,
                   "n_blocks": jcfg.n_blocks, "decoder_dim": jcfg.decoder_dim,
                   "model_shards": [1], "use_pallas": False, "comm_chunks": 1,
                   "normalized": ["x", "y"], "normalizer": "meanstd",
                   "x_stats": STATS["x"], "y_stats": STATS["y"]}, f)
    return d


def _by_rid(done) -> dict:
    return {r.rid: [np.asarray(y) for y in r.outputs] for r in done}


def test_fleet_cli_matches_the_reference_cli(jax_checkpoint, tmp_path, monkeypatch, capsys):
    recorded = []
    check = jserve_pde.check_served

    def record(done, requests, failed):
        recorded.append(list(done))
        return check(done, requests, failed)

    monkeypatch.setattr(jserve_pde, "check_served", record)
    monkeypatch.setattr(sys, "argv", ["serve_pde.py", "--ckpt-dir", jax_checkpoint,
                                      "--cache-store", str(tmp_path / "jstore")] + FLEET_FLAGS)
    jserve_pde.main()
    jout = capsys.readouterr().out
    got = serve_pde.main(["--ckpt-dir", jax_checkpoint, "--device", "cpu", "--verify",
                          "--cache-store", str(tmp_path / "tstore")] + FLEET_FLAGS)
    out = capsys.readouterr().out
    for line in ("  replica r0: routed 8, served 8", "  replica r1: routed 0, served 0",
                 "fleet geomodel cache: hit-rate", "cache store: 0 hits / 1 misses",
                 "verify OK: 8 scenarios"):
        assert line in out, out
    assert "2 replicas policy=affinity" in out and "2 replicas policy=affinity" in jout
    want = _by_rid(recorded[0])
    assert sorted(want) == sorted(r.rid for r in got) == list(range(8))
    for rid, steps in _by_rid(got).items():
        assert len(steps) == len(want[rid]) == 2
        for g, w in zip(steps, want[rid]):
            np.testing.assert_allclose(g, w, **TOL)
    assert os.listdir(tmp_path / "tstore") and os.listdir(tmp_path / "jstore")


def test_fleet_cli_on_4_ranks_matches_the_one_rank_fleet(jax_checkpoint, tmp_path, capfd):
    one = serve_pde.main(["--ckpt-dir", jax_checkpoint, "--device", "cpu",
                          "--cache-store", "dict"] + FLEET_FLAGS)
    with one_launch_at_a_time():
        four = serve_pde.main(["--ckpt-dir", jax_checkpoint, "--device", "cpu", "--devices",
                               "4", "--model-shards", "4", "--cache-store",
                               str(tmp_path / "store"), "--verify"] + FLEET_FLAGS)
    out = capfd.readouterr().out  # the ranks print to the inherited descriptor
    assert "(rank 0 of 4)" in out and "2 replicas policy=affinity" in out
    assert "verify OK: 8 scenarios" in out and "cache store: 0 hits / 1 misses" in out
    want = _by_rid(one)
    assert sorted(r.rid for r in four) == sorted(want) == list(range(8))
    for rid, steps in _by_rid(four).items():
        for g, w in zip(steps, want[rid]):
            np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("replicas", ["1", "2"])
def test_cli_step_budget_exits_as_the_reference(jax_checkpoint, monkeypatch, replicas):
    """A --max-steps budget too small for the ensemble ends both CLIs with
    the reference's words (the scheduler or the gateway warns first)."""
    flags = ["--ckpt-dir", jax_checkpoint, "--replicas", replicas, "--max-steps", "1",
             "--scenarios", "4", "--max-batch", "1"]
    words = r"served \d/4 scenarios; raise --max-steps"
    monkeypatch.setattr(sys, "argv", ["serve_pde.py"] + flags)
    with pytest.warns(RuntimeWarning, match="max_steps=1 exhausted"):
        with pytest.raises(SystemExit, match=words) as jexit:
            jserve_pde.main()
    with pytest.warns(RuntimeWarning, match="max_steps=1 exhausted"):
        with pytest.raises(SystemExit, match=words) as texit:
            serve_pde.main(flags + ["--device", "cpu"])
    assert str(texit.value) == str(jexit.value)


def test_fleet_cli_refuses_zero_replicas_as_the_reference(jax_checkpoint, monkeypatch):
    words = "--replicas must be >= 1, got 0"
    monkeypatch.setattr(sys, "argv", ["serve_pde.py", "--ckpt-dir", jax_checkpoint,
                                      "--replicas", "0"])
    with pytest.raises(SystemExit, match=words):
        jserve_pde.main()
    with pytest.raises(SystemExit, match=words):
        serve_pde.main(["--ckpt-dir", jax_checkpoint, "--device", "cpu", "--replicas", "0"])
