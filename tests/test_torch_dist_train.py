"""The port's distributed training vs the JAX package, on the CPU.

One launch of 4 gloo ranks runs ``tests/torch_dist_train_checks.py``: the
distributed train step (``make_train_step`` with a ``StateLayout``) for 2
steps at accum 2 on (1 data x 2x2 pencils), (2 x 2) and (4 x 1), ZeRO-1
on everywhere and also off on (2 x 2); a checkpoint saved on (2 x 2) and
restored onto (1 x 2x2); and the per-rank loader reads of each layout.
This process holds the gathered results against the JAX package's serial
``make_train_step`` (``use_pallas=True``, its Pallas kernels in interpret
mode) on the same numpy params and batches at rtol 1e-4, atol 1e-5 (as
``tests/test_torch_train.py``), the ZeRO-1 moments against the unsharded
ones bitwise, the loader batches against the port's serial loader's
bitwise, and the restored states against the saved one bitwise, on 4
ranks and on one.

Then the trainer CLI on 4 CPU ranks (``--model-shards 2 2``, an injected
fault): its losses against the port's serial CLI at rel 1e-4, and its
checkpoint served by the port's runner and by the JAX runner.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_train_checks as rank_side
from torch_dist_checks import one_launch_at_a_time
from repro.core import fno as jfno
from repro.data import ArrayStore as JStore
from repro.serve import FNORunner as JRunner
from repro.serve import ScenarioRequest as JRequest
from repro.serve import Scheduler as JScheduler
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import warmup_cosine as jax_warmup_cosine
from repro_torch.core import fno as tfno
from repro_torch.data.loader import ShardedDatasetLoader
from repro_torch.data.store import ArrayStore
from repro_torch.launch import train as ttrain_cli
from repro_torch.launch.mesh import launch_ranks
from repro_torch.serve import FNORunner, ScenarioRequest, Scheduler
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.optimizer import init_opt_state

RTOL, ATOL = 1e-4, 1e-5
CFG = dict(grid=(8, 8, 4, 4), modes=(2, 2, 1, 2), width=3, n_blocks=2, decoder_dim=5)
BATCH, ACCUM, STEPS = 8, 2, 2
OPT_KW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0, grad_clip=0.01)
STEP_RUNS = ("1x2x2", "2x2", "4x1", "2x2_no_zero1")
TIMEOUT_S = 240


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _write_stores(root, n, grid, seed):
    """x/y stores as the datagen CLI lays them out (chunked along x), with
    meanstd stats on x."""
    rng = np.random.default_rng(seed)
    data = {"x": (1.5 * rng.standard_normal((n, 1) + grid) + 0.3).astype(np.float32),
            "y": rng.standard_normal((n, 1) + grid).astype(np.float32)}
    for k, a in data.items():
        s = JStore.create(os.path.join(root, k), a.shape, "f4", (1, 1, grid[0] // 2) + grid[1:])
        for i in range(n):
            s.write_sample(i, a[i])
        s.update_meta(stats={"mean": [float(a.mean())], "std": [float(a.std())]})
    return data


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_train")
    jcfg = jfno.FNOConfig(**CFG, use_pallas=True)
    params = jax.device_get(jfno.init_params(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(5)
    batches = [{"x": rng.standard_normal((BATCH, 1) + CFG["grid"]).astype(np.float32),
                "y": rng.standard_normal((BATCH, 1) + CFG["grid"]).astype(np.float32)}
               for _ in range(STEPS)]
    _write_stores(str(root / "ds"), 10, CFG["grid"], seed=6)
    with one_launch_at_a_time():
        ranks = launch_ranks(rank_side.run_train, 4, str(root),
                             args=(params, batches, CFG, OPT_KW, ACCUM, str(root / "ds"),
                                   str(root / "ck")),
                             deadline_s=TIMEOUT_S, device="cpu")

    def jloss(p, b):
        return jfno.mse_loss(jfno.fno_forward(p, b["x"], jcfg), b["y"]), {}

    jstep = jax.jit(jax_make_train_step(
        jloss, JAdamWConfig(lr=jax_warmup_cosine(1e-2, 1, 4), **OPT_KW), grad_accum=ACCUM))
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jax_init_opt_state(jp)
    jmetrics = []
    for b in batches:
        jp, jopt, m = jstep(jp, jopt, jax.tree.map(jnp.asarray, b))
        jmetrics.append({k: float(v) for k, v in m.items()})
    return {"ranks": ranks, "jax_metrics": jmetrics,
            "jax_state": jax.device_get({"params": jp, "opt": jopt}), "root": root}


@pytest.mark.parametrize("layout", STEP_RUNS)
def test_dist_train_step_matches_jax(run, layout):
    """Loss, grad norm and lr of every step, then every param and moment
    after the last, against the JAX serial train step."""
    got = run["ranks"][0]["steps"][layout]
    for mine, ref in zip(got["metrics"], run["jax_metrics"]):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(mine[key], ref[key], rtol=RTOL, atol=ATOL, err_msg=key)
        assert mine["lr"] == pytest.approx(ref["lr"], rel=1e-7)
    want = dict(_leaves(run["jax_state"]))
    for name, t in _leaves(got["state"]):
        w = np.asarray(want[name])
        if name.startswith("opt.mu.") and np.iscomplexobj(w):
            w = np.conj(w)  # torch's .grad convention: mu of a complex leaf
        np.testing.assert_allclose(_np(t), w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_zero1_moments_are_sliced_and_equal_the_unsharded_ones(run):
    """On (2 x 2) ZeRO-1 gives each data rank half of every divisible
    moment leaf, and the gathered moments and the params are bitwise those
    of the unsharded update."""
    steps = run["ranks"][0]["steps"]
    for (name, a), (_, b) in zip(_leaves(steps["2x2"]["state"]),
                                 _leaves(steps["2x2_no_zero1"]["state"])):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    for r in run["ranks"][1:]:
        assert r["mu_shapes"]["2x2"] != r["mu_shapes"]["2x2_no_zero1"]
    sliced = run["ranks"][1]["mu_shapes"]
    # w_spec's local shard [2, 3, 3, 4, 2, 2, 2]: ZeRO-1 halves k_x (dim 3)
    assert (2, 3, 3, 2, 2, 2, 2) in sliced["2x2"] and (2, 3, 3, 4, 2, 2, 2) in sliced["2x2_no_zero1"]


@pytest.mark.parametrize("layout", list(rank_side.LAYOUTS))
def test_per_rank_loader_reads_gather_to_the_serial_batch(run, layout):
    """Each rank reads only its rows and x/y slices; gathered, the batches
    are bitwise the serial loader's (which ``tests/test_torch_train.py``
    holds bitwise to the JAX loader's; that loader is left out here, since
    the reference shares one zstd context among its read threads and then
    corrupts a chunk now and then: ROADMAP Queue 3)."""
    root = run["root"] / "ds"
    with ShardedDatasetLoader({k: ArrayStore.open(str(root / k)) for k in ("x", "y")}, BATCH,
                              device="cpu", seed=3, prefetch=0) as serial:
        for got, step in zip(run["ranks"][0]["loader"][layout], (0, 1, 2, 0)):
            want = serial.batch(step)
            for k in ("x", "y"):
                np.testing.assert_array_equal(_np(got[k]), _np(want[k]), err_msg=k)


def test_checkpoint_saved_on_2x2_resumes_on_pencils_and_on_one_rank_bitwise(run):
    saved = run["ranks"][0]["steps"]["2x2"]["state"]
    restored = run["ranks"][0]["restored_on_1x2x2"]
    assert restored["step"] == rank_side.CKPT_STEP
    for (name, a), (_, b) in zip(_leaves(restored["state"]), _leaves(saved)):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)
    cfg = tfno.FNOConfig(**CFG)
    params = tfno.init_params(cfg, device="cpu")
    one = {"params": params, "opt": init_opt_state(params)}
    step, _ = tckpt.restore_into(str(run["root"] / "ck"), one)
    assert step == rank_side.CKPT_STEP
    for (name, a), (_, b) in zip(_leaves(one), _leaves(saved)):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=name)


def test_restore_reads_only_its_region_of_a_leaf_saved_in_shards(tmp_path):
    """A leaf written as two shards, as the JAX trainer writes a
    model-parallel one: a region read takes each shard's overlap, and
    equals that region of the whole leaf bitwise."""
    full = np.arange(6 * 4 * 2, dtype=np.float32).reshape(6, 4, 2)
    d = tmp_path / "step_00000003"
    d.mkdir()
    np.save(d / "w.0.npy", full[:4])
    np.save(d / "w.1.npy", full[4:])
    shards = [{"file": "w.0.npy", "index": [[0, 4], [0, 4], [0, 2]]},
              {"file": "w.1.npy", "index": [[4, 6], [0, 4], [0, 2]]}]
    (d / "manifest.json").write_text(json.dumps(
        {"step": 3, "extra": {}, "leaves": {"w": {"shape": [6, 4, 2], "dtype": "float32",
                                                  "shards": shards}}}))
    _, _, load = tckpt._open(str(tmp_path), None)
    np.testing.assert_array_equal(load("w", (6, 4, 2)), full)
    for region in ((slice(3, 5), slice(1, 3), slice(0, 2)), (slice(0, 2), slice(0, 4), slice(1, 2)),
                   (slice(4, 6), slice(2, 4), slice(0, 1))):
        np.testing.assert_array_equal(load("w", (6, 4, 2), region), full[region])
    with pytest.raises(ValueError, match="ckpt shape"):
        load("w", (6, 4, 3))


def test_cli_on_4_ranks_matches_the_serial_cli_and_both_runners_serve_it(tmp_path, capsys):
    """``--devices 4 --model-shards 2 2`` on the CPU, through an injected
    fault: the losses of the serial CLI at rel 1e-4, and the checkpoint
    serves through the port's runner and the JAX runner alike."""
    common = ["--steps", "6", "--save-every", "2", "--inject-fault", "3", "--grid", "8", "8",
              "4", "4", "--width", "4", "--n-data", "8", "--batch", "4", "--device", "cpu"]
    serial = ttrain_cli.main(common + ["--ckpt-dir", str(tmp_path / "one")])
    with one_launch_at_a_time():
        dist_res = ttrain_cli.main(common + ["--devices", "4", "--model-shards", "2", "2",
                                             "--comm-chunks", "2",
                                             "--ckpt-dir", str(tmp_path / "four")])
    assert "steps=6 failures=1 restores=1" in capsys.readouterr().out
    assert (dist_res.failures, dist_res.restores) == (1, 1)
    assert [s for s, _ in dist_res.metrics_log] == list(range(6))
    for (_, a), (_, b) in zip(dist_res.metrics_log, serial.metrics_log):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)

    ckpt = str(tmp_path / "four")
    trunner = FNORunner.from_checkpoint(ckpt, device="cpu", max_slots=1)
    jrunner = JRunner.from_checkpoint(ckpt, model_shards=(1,), max_slots=1)
    assert trunner.restored_step == jrunner.restored_step == 5
    x = np.random.default_rng(9).standard_normal((1, 8, 8, 4, 4)).astype(np.float32)
    outs = []
    for sched_cls, req_cls, runner in ((JScheduler, JRequest, jrunner),
                                       (Scheduler, ScenarioRequest, trunner)):
        sched = sched_cls(runner, 1)
        sched.submit(req_cls(rid=0, x=x.copy(), steps=1))
        done = sched.run_until_done(max_steps=10)
        assert not sched.failed and len(done) == 1
        outs.append(done[0].outputs[0])
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL, atol=ATOL)


def test_cli_on_4_ranks_needs_a_card_or_device_cpu(monkeypatch, tmp_path):
    """Without a card and without ``--device cpu`` the 4-rank CLI raises
    before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_cli.main(["--devices", "4", "--model-shards", "2", "2", "--steps", "1",
                         "--ckpt-dir", str(tmp_path)])
