"""The port's FNO serving vs the JAX reference's, on the CPU.

Both runners get the same params (crossed over through numpy), the same
normalizers and the same scenario requests, and are driven through their
own schedulers. Gate: rtol=1e-4, atol=1e-5; cold vs warm cache serving
within the port is bitwise.
"""
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import fno as jfno
from repro.core.partition import make_mesh
from repro.data.loader import Normalizer as JNormalizer
from repro.launch.train import write_fno_serving_config
from repro.serve import FNORunner as JRunner
from repro.serve import ScenarioRequest as JRequest
from repro.serve import Scheduler as JScheduler
from repro.train import checkpoint as jckpt
from repro_torch.core import fno as tfno
from repro_torch.data.loader import Normalizer
from repro_torch.serve import FNORunner, ScenarioRequest, Scheduler
from repro_torch.train import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
GRID, MODES = (8, 4, 4, 4), (2, 1, 1, 2)
STATS = {"mean": [0.2, -0.1], "std": [1.5, 0.7], "absmax": [3.0, 2.0]}
Y_STATS = {"mean": [0.05], "std": [0.9], "absmax": [1.0]}


def _cfgs(in_channels, grid=GRID):
    kw = dict(grid=grid, modes=MODES, width=3, in_channels=in_channels,
              n_blocks=2, decoder_dim=5)
    return jfno.FNOConfig(**kw), tfno.FNOConfig(**kw)


@pytest.fixture(scope="module")
def models():
    out = {}
    for c in (1, 2):
        jcfg, tcfg = _cfgs(c)
        params = jax.device_get(jfno.init_params(jax.random.PRNGKey(10 + c), jcfg))
        out[c] = (jcfg, tcfg, params)
    return out


def _norms(cls, c):
    x = {k: v[:c] for k, v in STATS.items()}
    return cls.from_stats(x, "meanstd"), cls.from_stats(Y_STATS, "meanstd")


def _inputs(c, n, shared_static):
    rng = np.random.default_rng(c * 100 + n)
    xs = [rng.standard_normal((c,) + GRID).astype(np.float32) for _ in range(n)]
    if shared_static:
        for x in xs[1:]:
            x[0] = xs[0][0]
    return xs


def _serve(sched_cls, req_cls, runner, xs, steps, max_slots=2):
    sched = sched_cls(runner, max_slots)
    reqs = [req_cls(rid=i, x=x.copy(), steps=steps) for i, x in enumerate(xs)]
    for r in reqs:
        sched.submit(r)
    done = sched.run_until_done(max_steps=100)
    assert not sched.failed and len(done) == len(reqs)
    return [r.outputs for r in sorted(done, key=lambda r: r.rid)]


def _port_runner(tcfg, params, **kw):
    xn, yn = _norms(Normalizer, tcfg.in_channels)
    return FNORunner(
        tcfg, tfno.params_from_numpy(params, "cpu"), device="cpu", max_slots=2,
        x_normalizer=xn, y_normalizer=yn, **kw,
    )


# (in_channels, n_static, cache_level)
MODES_SERVED = [(1, 0, "deep"), (2, 1, "prelift"), (2, 1, "deep")]


@pytest.mark.parametrize("c,n_static,level", MODES_SERVED)
def test_runner_matches_jax(models, c, n_static, level):
    jcfg, tcfg, params = models[c]
    xs = _inputs(c, 3, shared_static=bool(n_static))
    xn, yn = _norms(JNormalizer, c)
    jrunner = JRunner(
        jcfg, params, mesh=make_mesh((1,), ("data",)), model_axis=None,
        max_slots=2, x_normalizer=xn, y_normalizer=yn, n_static=n_static,
        cache_level=level,
    )
    want = _serve(JScheduler, JRequest, jrunner, xs, steps=2)
    trunner = _port_runner(tcfg, params, n_static=n_static, cache_level=level)
    got = _serve(Scheduler, ScenarioRequest, trunner, xs, steps=2)
    for g_steps, w_steps in zip(got, want):
        assert len(g_steps) == 2
        for g, w in zip(g_steps, w_steps):
            assert g.shape == (1,) + GRID
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    if n_static:
        assert trunner.cache.stats["hit_rate"] > 0


@pytest.mark.parametrize("level", ["prelift", "deep"])
def test_cold_equals_warm_bitwise(models, level):
    jcfg, tcfg, params = models[2]
    xs = _inputs(2, 3, shared_static=True)
    cold = _serve(Scheduler, ScenarioRequest,
                  _port_runner(tcfg, params, n_static=1, cache=None, cache_level=level),
                  xs, steps=2)
    warm_runner = _port_runner(tcfg, params, n_static=1, cache_level=level)
    for _ in range(2):  # the second pass is served from a warm cache only
        warm = _serve(Scheduler, ScenarioRequest, warm_runner, xs, steps=2)
        for c_steps, w_steps in zip(cold, warm):
            for a, b in zip(c_steps, w_steps):
                np.testing.assert_array_equal(a, b)
    assert warm_runner.cache.stats["misses"] == 1


def _jax_checkpoint(tmp_path, jcfg, params):
    d = str(tmp_path / "ck")
    jckpt.save(d, 7, {"params": params, "opt": {"step": np.int32(7)}})
    src = types.SimpleNamespace(meta={"stats": {k: v[:jcfg.in_channels] for k, v in STATS.items()}})
    ysrc = types.SimpleNamespace(meta={"stats": Y_STATS})
    write_fno_serving_config(d, jcfg, types.SimpleNamespace(model_shards=[2]), src, ysrc,
                             normalized=("x",))
    return d


def test_from_checkpoint_written_by_jax(models, tmp_path, capsys):
    jcfg, tcfg, params = models[1]
    d = _jax_checkpoint(tmp_path, jcfg, params)
    runner = FNORunner.from_checkpoint(d, device="cpu", max_slots=2)
    assert "model_shards=[2]" in capsys.readouterr().out
    assert runner.restored_step == 7 and runner.cfg == tcfg
    got = tfno.params_to_numpy(runner.params)
    for group in params:
        for name, leaf in params[group].items():
            np.testing.assert_array_equal(got[group][name], leaf)
    jrunner = JRunner.from_checkpoint(d, model_shards=(1,), max_slots=2)
    xs = _inputs(1, 2, shared_static=False)
    want = _serve(JScheduler, JRequest, jrunner, xs, steps=1)
    out = _serve(Scheduler, ScenarioRequest, runner, xs, steps=1)
    for g, w in zip(out, want):
        np.testing.assert_allclose(g[0], w[0], rtol=RTOL, atol=ATOL)


def test_checkpoint_restore_reassembles_shards(tmp_path):
    """A leaf the JAX trainer saved as model-parallel shards (one file per
    slice) comes back whole; the port's own saves read back in JAX too."""
    d = tmp_path / "ck"
    step = d / "step_00000003"
    step.mkdir(parents=True)
    full = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    shards = []
    for i, (a, b) in enumerate([(0, 4), (4, 6)]):
        np.save(step / f"w.{i}.npy", full[:, a:b])
        shards.append({"file": f"w.{i}.npy", "index": [[0, 2], [a, b], [0, 3]]})
    manifest = {"step": 3, "extra": {}, "leaves": {"w": {
        "shape": [2, 6, 3], "dtype": "float32", "shards": shards}}}
    (step / "manifest.json").write_text(json.dumps(manifest))
    tree, s, _ = tckpt.restore(str(d), {"w": (2, 6, 3)})
    assert s == 3
    np.testing.assert_array_equal(tree["w"], full)
    with pytest.raises(ValueError, match="ckpt shape"):
        tckpt.restore(str(d), {"w": (2, 6, 4)})

    d2 = str(tmp_path / "ck2")
    tree = {"a": {"b": np.ones((2, 3), np.complex64)}, "c": torch.arange(4.0)}
    for k in (1, 2, 3, 4):
        tckpt.save(d2, k, tree, keep=2)
    assert tckpt.all_steps(d2) == [3, 4] and tckpt.latest_step(d2) == 4
    abstract = {"a": {"b": jax.ShapeDtypeStruct((2, 3), np.complex64)},
                "c": jax.ShapeDtypeStruct((4,), np.float32)}
    back, s, _ = jckpt.restore(d2, abstract)
    assert s == 4
    np.testing.assert_array_equal(np.asarray(back["a"]["b"]), tree["a"]["b"])
    np.testing.assert_array_equal(np.asarray(back["c"]), tree["c"].numpy())


@pytest.mark.parametrize("ensemble", [False, True], ids=["plain", "ensemble"])
def test_cli_serves_and_verifies_on_cpu(tmp_path, ensemble):
    c = 2 if ensemble else 1
    grid = (8, 6, 4, 4)  # room for build_scenarios' wells
    _, tcfg = _cfgs(c, grid)
    params = tfno.init_params(tcfg, generator=torch.Generator().manual_seed(1), device="cpu")
    d = str(tmp_path / "ck")
    tckpt.save(d, 1, {"params": params})
    cfg_json = {
        "grid": list(grid), "modes": list(MODES), "width": tcfg.width,
        "in_channels": c, "out_channels": 1, "n_blocks": tcfg.n_blocks,
        "decoder_dim": tcfg.decoder_dim, "model_shards": [1],
        "normalized": ["x"], "normalizer": "meanstd",
        "x_stats": {k: v[:c] for k, v in STATS.items()}, "y_stats": None,
    }
    with open(os.path.join(d, "fno_config.json"), "w") as f:
        json.dump(cfg_json, f)
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_pde", "--ckpt-dir", d,
           "--device", "cpu", "--scenarios", "3", "--max-batch", "2",
           "--rollout-steps", "2", "--verify", "--bench-sequential"]
    if ensemble:
        cmd += ["--ensemble", "--dup", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "verify OK" in out.stdout
    if ensemble:
        assert "geomodel cache: hit-rate" in out.stdout


def test_no_device_and_no_card_raises(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    jcfg, tcfg, params = models[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfno.init_params(tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfno.params_from_numpy(params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FNORunner(tcfg, tfno.params_from_numpy(params, "cpu"))
