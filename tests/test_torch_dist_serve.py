"""The port's model-parallel FNO serving vs the JAX package, on the CPU.

One launch of 4 gloo ranks runs ``tests/torch_dist_serve_checks.py``: the
split and deep-split distributed forwards (paper, eager, grady31 on (1
data x 4 model) and (2 x 2); paper and eager on (1 x 2x2) pencils) at
``comm_chunks=2``, two deep forwards fed a wrongly scattered contribution,
and ``FNORunner`` over the (2 x 2) and (1 x 2x2) rank groups, plain,
``prelift`` and ``deep``. This process holds the forwards against the JAX
package's unfused serial ``fno_forward`` on the same numpy parameters and
input (the config and inputs of ``tests/distributed_checks.py``'s
``fno_deep_split_matches_serial``), the served outputs against the JAX
one-device ``FNORunner`` on the same requests (through the same
normalizers), cold against warm serving bitwise, and shows the gate
refusing the wrongly scattered contributions. Gate: rtol 1e-4, atol 1e-5.

Then the serving CLI on 4 CPU ranks (``--devices 4 --model-shards 2 2
--verify``) on a checkpoint the port's trainer wrote, against the
one-rank CLI, and its refusals.
"""
import json
import time
import types

import jax
import numpy as np
import pytest
import torch

import torch_dist_serve_checks as rank_side
from torch_dist_checks import one_launch_at_a_time
from repro.core import fno as jfno
from repro.core.partition import make_mesh
from repro.data.loader import Normalizer as JNormalizer
from repro.serve import FNORunner as JRunner
from repro.serve import ScenarioRequest as JRequest
from repro.serve import Scheduler as JScheduler
from repro.launch.train import write_fno_serving_config
from repro.train import checkpoint as jckpt
from repro_torch.launch import serve_pde
from repro_torch.launch import train as ttrain_cli
from repro_torch.launch.mesh import launch_ranks

CFG = dict(grid=(16, 16, 8, 8), modes=(4, 4, 2, 3), width=6, in_channels=2,
           out_channels=1, n_blocks=2, decoder_dim=8)
COMM_CHUNKS = 2
TOL = dict(rtol=1e-4, atol=1e-5)
STATS = {"x": {"mean": [0.2, -0.1], "std": [1.5, 0.7]}, "y": {"mean": [0.05], "std": [0.9]}}
N_REQUESTS = 3
TIMEOUT_S = 240

FORWARDS = [f"{kind}_{v}_{layout}" for layout in rank_side.LAYOUTS
            for v in rank_side.variants_of(layout) for kind in ("split", "deep")]
WRONG = ("wrong_contrib_k_y_k_z_swapped_1x2x2", "wrong_contrib_neighbouring_k_y_shard_1x4")
SERVED = [f"{name}_{layout}" for layout in rank_side.RUNNER_LAYOUTS
          for name, _, _ in rank_side.RUNNER_KINDS]
CHECKS = (rank_side.RANK_CHECK_NAMES
          + tuple(f"forward_{f}_vs_jax_serial" for f in FORWARDS)
          + tuple(f"gate_refuses_{w}" for w in WRONG)
          + tuple(f"runner_{s}_vs_jax_runner" for s in SERVED + ["from_jax_checkpoint_1x2x2"])
          + tuple(f"runner_{s}_cold_equals_warm_bitwise" for s in SERVED
                  if not s.startswith("plain")))


def _compare(got, want) -> dict:
    got, want = np.asarray(got), np.asarray(want)
    try:
        np.testing.assert_allclose(got, want, **TOL)
    except AssertionError as e:
        return {"ok": False, "detail": str(e)}
    return {"ok": True, "detail": f"max|d|={float(np.abs(got - want).max()):.3e}"}


def _requests(rng):
    """N_REQUESTS raw inputs sharing one static (geomodel) channel."""
    xs = [rng.standard_normal((CFG["in_channels"],) + CFG["grid"]).astype(np.float32)
          for _ in range(N_REQUESTS)]
    for x in xs[1:]:
        x[0] = xs[0][0]
    return xs


def _jax_served(params, xs, n_static, level) -> list:
    jcfg = jfno.FNOConfig(**CFG)
    norms = [JNormalizer.from_stats(STATS[k], "meanstd") for k in ("x", "y")]
    runner = JRunner(jcfg, params, mesh=make_mesh((1,), ("data",)), model_axis=None,
                     max_slots=rank_side.MAX_SLOTS, x_normalizer=norms[0],
                     y_normalizer=norms[1], n_static=n_static, cache_level=level)
    sched = JScheduler(runner, rank_side.MAX_SLOTS)
    reqs = [JRequest(rid=i, x=x.copy(), steps=rank_side.SERVE_STEPS) for i, x in enumerate(xs)]
    for r in reqs:
        sched.submit(r)
    done = sched.run_until_done(max_steps=100)
    assert not sched.failed and len(done) == len(reqs)
    return [r.outputs for r in sorted(done, key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_serve")
    jcfg = jfno.FNOConfig(**CFG, use_pallas=False)
    params = jax.device_get(jfno.init_params(jax.random.PRNGKey(0), jcfg))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 2) + CFG["grid"]), np.float32)
    n = rank_side.N_STATIC
    pre_s = jfno.encoder_prelift(params, x[:, :n], jcfg, slice(0, n))
    _, contrib = jfno.spectral_prelift(params, pre_s, jcfg)
    inputs = {"pre_static": np.asarray(pre_s, np.float32), "x_dyn": x[:, n:],
              "contrib": np.asarray(contrib, np.complex64)}
    xs = _requests(np.random.default_rng(2))
    # the same params as a checkpoint the JAX trainer wrote (with these
    # normalizers), for the ranks to restore onto the pencils
    jax_ckpt = str(root / "jax_ck")
    jckpt.save(jax_ckpt, 7, {"params": params, "opt": {"step": np.int32(7)}})
    write_fno_serving_config(jax_ckpt, jfno.FNOConfig(**CFG), types.SimpleNamespace(
        model_shards=[4]), types.SimpleNamespace(meta={"stats": STATS["x"]}),
        types.SimpleNamespace(meta={"stats": STATS["y"]}), normalized=("x", "y"))

    t0 = time.perf_counter()
    with one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_serve_checks, 4, str(root),
                             args=(params, inputs, xs, dict(CFG, comm_chunks=COMM_CHUNKS),
                                   STATS, jax_ckpt),
                             deadline_s=TIMEOUT_S, device="cpu")
    launch_s = time.perf_counter() - t0

    out = {}
    for name in rank_side.RANK_CHECK_NAMES:
        per_rank = [r["checks"].get(name, (False, "missing")) for r in ranks]
        bad = [f"rank {i}: {detail}" for i, (ok, detail) in enumerate(per_rank) if not ok]
        out[name] = {"ok": not bad, "detail": "\n".join(bad) or per_rank[0][1]}

    y_ser = np.asarray(jax.jit(lambda p, x: jfno.fno_forward(p, x, jcfg))(params, x))
    outputs, served = ranks[0]["outputs"], ranks[0]["served"]
    for f in FORWARDS:
        out[f"forward_{f}_vs_jax_serial"] = _compare(outputs[f], y_ser)
    for w in WRONG:
        r = _compare(outputs[w], y_ser)
        out[f"gate_refuses_{w}"] = {"ok": not r["ok"],
                                    "detail": "refused" if not r["ok"] else "the gate passed it"}
    want = {name: _jax_served(params, xs, n_static, level)
            for name, n_static, level in rank_side.RUNNER_KINDS}
    for s in SERVED + ["from_jax_checkpoint_1x2x2"]:
        name = "plain" if s.startswith("from_jax") else s.split("_")[0]
        entry = served[s]
        first = entry["passes"][0]
        worst, failed = 0.0, []
        for rid, (g_steps, w_steps) in enumerate(zip(first, want[name])):
            for step, (g, w) in enumerate(zip(g_steps, w_steps)):
                r = _compare(g.numpy(), w)
                if not r["ok"]:
                    failed.append(f"rid {rid} step {step}: {r['detail']}")
                else:
                    worst = max(worst, float(np.abs(g.numpy() - np.asarray(w)).max()))
        out[f"runner_{s}_vs_jax_runner"] = {
            "ok": not failed and len(first) == N_REQUESTS and entry.get("step", 7) == 7,
            "detail": "\n".join(failed) or f"max|d|={worst:.3e}, buckets {entry['buckets']}"}
        if name != "plain":
            same = all(torch.equal(a, b) for p in entry["passes"]
                       for c_steps, p_steps in zip(entry["cold"], p)
                       for a, b in zip(c_steps, p_steps))
            stats = entry["stats"]
            out[f"runner_{s}_cold_equals_warm_bitwise"] = {
                "ok": same and stats["misses"] == 1 and stats["hit_rate"] > 0,
                "detail": f"bitwise {same}, cache {stats['hits']} hits / {stats['misses']} misses"}
    out["launch_seconds"] = launch_s
    path = root / "checks.json"
    path.write_text(json.dumps(out, indent=1))
    return path


@pytest.mark.parametrize("check", CHECKS)
def test_dist_serve_check(results, check):
    entry = json.loads(results.read_text()).get(check)
    assert entry is not None, f"{check} was not run"
    assert entry["ok"], entry["detail"]


CLI_COMMON = ["--scenarios", "3", "--max-batch", "2", "--rollout-steps", "2", "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint the port's trainer wrote (one rank, pencil-divisible grid)."""
    d = str(tmp_path_factory.mktemp("dist_serve_ckpt"))
    ttrain_cli.main(["--steps", "2", "--save-every", "2", "--grid", "8", "8", "4", "4",
                     "--width", "4", "--n-data", "4", "--device", "cpu", "--ckpt-dir", d])
    return d


def test_cli_on_4_ranks_verifies_and_matches_the_one_rank_cli(trained, capfd):
    one = serve_pde.main(["--ckpt-dir", trained] + CLI_COMMON)
    with one_launch_at_a_time():
        four = serve_pde.main(["--ckpt-dir", trained, "--devices", "4", "--model-shards", "2",
                               "2", "--comm-chunks", "2", "--verify"] + CLI_COMMON)
    out = capfd.readouterr().out  # the ranks print to the inherited descriptor
    assert "serving on 1 data x 2x2 model ranks" in out and "(rank 0 of 4)" in out
    assert "verify OK: 3 scenarios" in out
    assert sorted(r.rid for r in four) == sorted(r.rid for r in one) == [0, 1, 2]
    by_rid = {r.rid: r for r in one}
    for r in four:
        assert len(r.outputs) == 2
        for a, b in zip(r.outputs, by_rid[r.rid].outputs):
            np.testing.assert_allclose(a, b, **TOL)


def test_cli_refuses_a_layout_the_flags_cannot_make(trained):
    for flags, words in ((["--devices", "3", "--model-shards", "2", "2"], "not divisible"),
                         (["--devices", "8", "--model-shards", "8"], r"2\*my=4 not divisible by 8 shards"),
                         (["--model-shards", "2", "2", "2"], r"1 \(x-decomposition\) or 2")):
        with pytest.raises(SystemExit, match="--devices/--model-shards/--static-channels: "
                                             f".*{words}"):
            serve_pde.main(["--ckpt-dir", trained] + flags + CLI_COMMON)


def test_cli_on_4_ranks_needs_a_card_or_device_cpu(monkeypatch, trained):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_pde.main(["--ckpt-dir", trained, "--devices", "4", "--model-shards", "2", "2"])
