"""The port's training path vs the JAX reference's, on the CPU.

Inputs, params and data are made with numpy (or by the JAX side) and handed
to both. The JAX side trains through ``use_pallas=True`` (the Pallas kernels
in interpret mode, remat on); the port's CPU path runs the kernels' plain
versions. Gradients of complex leaves compare in torch's convention (the
conjugate of JAX's); params, moments, losses, grad norms and learning rates
compare directly. Gate: rtol=1e-4, atol=1e-5 (float32 sums in another
order); restarts within the port are bitwise.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.train as jtrain_cli
from repro.common.tree import global_norm as jax_global_norm
from repro.core import fno as jfno
from repro.core.partition import make_mesh
from repro.data import ArrayStore as JStore
from repro.data import ShardedDatasetLoader as JLoader
from repro.serve import FNORunner as JRunner
from repro.serve import ScenarioRequest as JRequest
from repro.serve import Scheduler as JScheduler
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import adamw_update as jax_adamw_update
from repro.train import checkpoint as jckpt
from repro.train import init_opt_state as jax_init_opt_state
from repro.train import make_train_step as jax_make_train_step
from repro.train import warmup_cosine as jax_warmup_cosine
from repro_torch.common.tree import global_norm
from repro_torch.core import fno as tfno
from repro_torch.data.loader import ShardedDatasetLoader
from repro_torch.data.store import ArrayStore
from repro_torch.launch import train as ttrain_cli
from repro_torch.serve import FNORunner, ScenarioRequest, Scheduler
from repro_torch.train import checkpoint as tckpt
from repro_torch.train.fault import FaultInjector, run_supervised
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_update,
    init_opt_state,
    warmup_cosine,
)
from repro_torch.train.train_loop import accumulate_grads, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-4, 1e-5
KW = dict(grid=(8, 4, 4, 4), modes=(2, 1, 1, 2), width=3, n_blocks=2, decoder_dim=5)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------------------
# global norm, schedule, AdamW
# ---------------------------------------------------------------------------

def test_global_norm_counts_real_part_only_as_the_reference():
    """Finding 1: the reference's global_norm casts complex leaves to
    float32, which keeps the real part: |3+4j| counts as 3, not 5."""
    assert float(jax_global_norm({"a": jnp.asarray([3 + 4j], jnp.complex64)})) == 3.0
    assert float(global_norm({"a": torch.tensor([3 + 4j], dtype=torch.complex64)})) == 3.0
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((5, 4)).astype(np.float32),
            "z": {"c": _cplx(rng, (3, 7)), "b": rng.standard_normal(3).astype(np.float32)}}
    _close(global_norm(_tree(torch.from_numpy, tree)),
           jax_global_norm(_tree(jnp.asarray, tree)), rtol=1e-6, atol=0)


def test_warmup_cosine_matches_jax():
    """Both compute in float32; near the end of the decay 1 + cos(pi*p)
    cancels, so an ulp of cos is a large relative error there: the gate
    is 1e-6 relative or 1e-6 of the peak, whichever is larger."""
    for peak, warm, total, floor in ((1e-3, 10, 50, 0.0), (0.5, 3, 8, 0.01), (2.0, 0, 4, 0.0)):
        ours, ref = warmup_cosine(peak, warm, total, floor), jax_warmup_cosine(peak, warm, total, floor)
        for step in range(total + 3):
            assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-6 * peak)


@pytest.mark.parametrize("clip", [None, 1.0, 0.05], ids=["no-clip", "clip-loose", "clip-tight"])
def test_adamw_update_matches_jax(clip):
    """Three steps on real and complex leaves, decay on: the port fed
    torch-convention gradients (conj of JAX's on complex leaves) lands on
    the reference's params and moments."""
    rng = np.random.default_rng(1)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "blocks": {"z": _cplx(rng, (2, 3, 2)), "b": rng.standard_normal(2).astype(np.float32)}}
    kw = dict(lr=jax_warmup_cosine(0.05, 1, 5), b1=0.9, b2=0.95, eps=1e-8,
              weight_decay=0.1, grad_clip=clip)
    jcfg = JAdamWConfig(**kw)
    tcfg = AdamWConfig(**dict(kw, lr=warmup_cosine(0.05, 1, 5)))
    jp, tp = _tree(jnp.asarray, params), _tree(lambda a: torch.from_numpy(a.copy()), params)
    jopt, topt = jax_init_opt_state(jp), init_opt_state(tp)
    assert topt["nu"]["blocks"]["z"].dtype == torch.float32
    for _ in range(3):
        jg = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "blocks": {"z": _cplx(rng, (2, 3, 2)), "b": rng.standard_normal(2).astype(np.float32)}}
        tg = _tree(lambda a: torch.from_numpy(np.conj(a) if np.iscomplexobj(a) else a.copy()), jg)
        jp, jopt, jstats = jax_adamw_update(_tree(jnp.asarray, jg), jopt, jp, jcfg)
        tp, topt, tstats = adamw_update(tg, topt, tp, tcfg)
        _close(tstats["grad_norm"], jstats["grad_norm"], rtol=1e-6, atol=0)
        assert tstats["lr"] == pytest.approx(float(jstats["lr"]), rel=1e-7)
    assert int(topt["count"]) == int(jopt["count"]) == 3
    for (name, t), (_, j) in zip(_leaves(tp), _leaves(jp)):
        _close(t, j)
    for key in ("mu", "nu"):
        for (name, t), (_, j) in zip(_leaves(topt[key]), _leaves(jopt[key])):
            _close(t, j)


# ---------------------------------------------------------------------------
# the FNO's gradients and the train step
# ---------------------------------------------------------------------------

def _jax_params(jcfg, seed):
    return jax.device_get(jfno.init_params(jax.random.PRNGKey(seed), jcfg))


def test_block_views_remat_and_unfused_give_the_same_gradients(monkeypatch):
    """The train loop's per-block leaf views, remat on and off, the fused
    and the unfused forward, and a decoder cut into chunks all give the
    gradients of plain autograd on the stacked leaves."""
    cfg = tfno.FNOConfig(**KW)
    params = tfno.init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 1) + cfg.grid).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 1) + cfg.grid).astype(np.float32))

    leaves = _tree(lambda t: t.detach().clone().requires_grad_(), params)
    tfno.mse_loss(tfno.fno_forward(leaves, x, cfg), y).backward()
    want = _tree(lambda t: t.grad, leaves)

    monkeypatch.setattr(tfno, "DECODER_CHUNK", 48)  # 4 chunks of the 128-point grid
    for c, forward in ((cfg, tfno.fno_forward), (tfno.FNOConfig(**KW, remat=False), tfno.fno_forward),
                       (cfg, tfno.fno_forward_unfused)):
        grads = _tree(torch.zeros_like, params)
        accumulate_grads(lambda p, b: (tfno.mse_loss(forward(p, b["x"], c), b["y"]), {}),
                         params, {"x": x, "y": y}, grads)
        for (name, g), (_, w) in zip(_leaves(grads), _leaves(want)):
            _close(g, w.numpy())


@pytest.mark.parametrize("accum,clip", [(1, 1.0), (2, 0.01)], ids=["accum1", "accum2-clip"])
def test_train_step_matches_jax(accum, clip):
    """Two steps of make_train_step (remat on) vs the reference's on
    use_pallas=True params: loss, grad norm, lr and every param."""
    jcfg = jfno.FNOConfig(**KW, use_pallas=True)
    tcfg = tfno.FNOConfig(**KW)
    params = _jax_params(jcfg, 4)
    rng = np.random.default_rng(4)
    batches = [{"x": rng.standard_normal((2, 1) + KW["grid"]).astype(np.float32),
                "y": rng.standard_normal((2, 1) + KW["grid"]).astype(np.float32)}
               for _ in range(2)]
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0, grad_clip=clip)

    def jloss(p, b):
        return jfno.mse_loss(jfno.fno_forward(p, b["x"], jcfg), b["y"]), {}

    def tloss(p, b):
        return tfno.mse_loss(tfno.fno_forward(p, b["x"], tcfg), b["y"]), {}

    jstep = jax.jit(jax_make_train_step(
        jloss, JAdamWConfig(lr=jax_warmup_cosine(1e-2, 1, 4), **kw), grad_accum=accum))
    tstep = make_train_step(tloss, AdamWConfig(lr=warmup_cosine(1e-2, 1, 4), **kw),
                            grad_accum=accum)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jax_init_opt_state(jp)
    tp = tfno.params_from_numpy(params, "cpu")
    topt = init_opt_state(tp)
    for b in batches:
        jp, jopt, jm = jstep(jp, jopt, jax.tree.map(jnp.asarray, b))
        tp, topt, tm = tstep(tp, topt, _tree(torch.from_numpy, b))
        for key in ("loss", "grad_norm"):
            _close(tm[key], jm[key])
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-7)
    for (name, t), (_, j) in zip(_leaves(tp), _leaves(jax.device_get(jp))):
        _close(t, j)


# ---------------------------------------------------------------------------
# loader, checkpoints, supervisor
# ---------------------------------------------------------------------------

def _write_stores(root, n, grid, seed):
    """x/y stores as the datagen CLI lays them out, with meanstd stats."""
    rng = np.random.default_rng(seed)
    data = {"x": (1.5 * rng.standard_normal((n, 1) + grid) + 0.3).astype(np.float32),
            "y": rng.standard_normal((n, 1) + grid).astype(np.float32)}
    for k, a in data.items():
        s = JStore.create(os.path.join(root, k), a.shape, "f4", (1, 1, grid[0] // 2) + grid[1:])
        for i in range(n):
            s.write_sample(i, a[i])
        s.update_meta(stats={"mean": [float(a.mean())], "std": [float(a.std())]})
    return data


@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "in-order"])
def test_loader_matches_jax_loader(tmp_path, shuffle):
    """The port's prefetching loader, driven through replays and forward
    jumps, against the reference's loader read synchronously (its prefetch
    can wait forever on such a jump; see ``_Prefetcher``)."""
    data = _write_stores(str(tmp_path), 5, (4, 4, 2, 2), seed=5)
    spec = P("data", None, None, None, None, None)
    with JLoader({k: JStore.open(str(tmp_path / k)) for k in data}, make_mesh((1,), ("data",)),
                 3, {k: spec for k in data}, seed=7, shuffle=shuffle, prefetch=0) as jl, \
            ShardedDatasetLoader({k: ArrayStore.open(str(tmp_path / k)) for k in data}, 3,
                                 device="cpu", seed=7, shuffle=shuffle, prefetch=2) as tl:
        for step in (0, 1, 2, 3, 6, 2, 7):  # a replay out of order restarts the prefetch
            np.testing.assert_array_equal(tl.sample_ids(step), jl.sample_ids(step))
            tb, jb = tl.batch(step), jl.batch(step)
            for k in data:
                assert tb[k].dtype == torch.float32 and tb[k].device.type == "cpu"
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        assert not np.array_equal(tl.batch(0)["x"].numpy(), data["x"][tl.sample_ids(0)])


def test_prefetcher_never_waits_on_a_step_nobody_fetches():
    """Forward jumps past ready results while a fetch is in flight, and
    repeats of a step just fetched after a reset: every request returns
    (the reference's prefetcher can wait forever on both)."""
    import threading
    import time

    from repro_torch.data.loader import _Prefetcher

    def fetch(step):
        time.sleep(0.002 * (step % 3))
        return step

    pf = _Prefetcher(fetch, depth=2)
    order = [0, 1, 3, 3, 4, 8, 9, 9, 2, 6, 7, 7, 12, 13, 15, 15, 16] * 3
    got = []
    t = threading.Thread(target=lambda: got.extend(pf.get(s) for s in order), daemon=True)
    t.start()
    t.join(timeout=60)
    pf.stop()
    assert not t.is_alive(), f"prefetcher hung after {len(got)} of {len(order)} requests"
    assert got == order


def test_store_without_zstandard_raises_on_a_compressed_chunk(tmp_path):
    """A store written with zstd-compressed chunks, read where the package
    is missing: a clear error, never the compressed bytes as data."""
    JStore.create(str(tmp_path / "x"), (1, 2, 4), "f4", (1, 2, 4)).write_sample(
        0, np.arange(8, dtype=np.float32).reshape(2, 4))
    code = (
        "import sys; sys.modules['zstandard'] = None\n"
        "from repro_torch.data.store import ArrayStore\n"
        f"ArrayStore.open({str(tmp_path / 'x')!r}).read_chunk((0, 0, 0))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode != 0
    assert "zstd-compressed" in out.stderr and "'zstandard' package" in out.stderr


def test_store_reads_many_chunks_in_parallel_exactly(tmp_path):
    """read_slice decompresses 32 chunks a read on its thread pool; 20 reads
    come back bit-identical (one zstd context shared across the pool's
    threads corrupts chunks or crashes here)."""
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 64)).astype(np.float32)
    st = ArrayStore.create(str(tmp_path / "x"), x.shape, "f4", (1, 16, 16, 64))
    for i in range(2):
        st.write_sample(i, x[i])
    whole = (slice(0, 2), slice(0, 64), slice(0, 64), slice(0, 64))
    for _ in range(20):
        np.testing.assert_array_equal(st.read_slice(whole), x)


def _train_state(jcfg, params):
    """A JAX training state one AdamW step in, so every moment is nonzero."""
    p = jax.tree.map(jnp.asarray, params)
    opt = jax_init_opt_state(p)
    grads = jax.tree.map(lambda a: jnp.ones_like(a) * 0.01, p)
    p, opt, _ = jax_adamw_update(grads, opt, p, JAdamWConfig())
    return {"params": p, "opt": opt}


def test_training_checkpoints_resume_across_sides(tmp_path):
    """A whole training state written by either side loads into the
    other's, leaf for leaf under the reference's names."""
    jcfg, tcfg = jfno.FNOConfig(**KW), tfno.FNOConfig(**KW)
    jstate = _train_state(jcfg, _jax_params(jcfg, 6))
    jckpt.save(str(tmp_path / "j"), 3, jstate, extra={"who": "jax"})

    tparams = tfno.init_params(tcfg, device="cpu")
    tstate = {"params": tparams, "opt": init_opt_state(tparams)}
    step, extra = tckpt.restore_into(str(tmp_path / "j"), tstate)
    assert step == 3 and extra == {"who": "jax"}
    assert int(tstate["opt"]["count"]) == 1
    want = dict(_leaves(jax.device_get(jstate)))
    for name, t in _leaves(tstate):
        np.testing.assert_array_equal(t.numpy(), want[name])

    _, thread = tckpt.save(str(tmp_path / "t"), 4, tstate, extra={"who": "port"},
                           async_save=True)
    thread.join()
    abstract = jax.eval_shape(lambda: jstate)
    back, step, extra = jckpt.restore(str(tmp_path / "t"), abstract)
    assert step == 4 and extra == {"who": "port"}
    for (name, j), (_, t) in zip(_leaves(jax.device_get(back)), _leaves(tstate)):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_supervised_restart_is_bitwise_and_logs_each_step_once(tmp_path):
    """An injected fault at step 3 restores step 2's async checkpoint and
    replays: the final params equal an uninterrupted run's bit for bit (so
    the async snapshot was a copy, not a view of params AdamW kept
    changing), and the metrics log holds each step once."""
    cfg = tfno.FNOConfig(**KW)
    rng = np.random.default_rng(8)
    data = {k: torch.from_numpy(rng.standard_normal((6, 2, 1) + cfg.grid).astype(np.float32))
            for k in ("x", "y")}
    step_fn = make_train_step(
        lambda p, b: (tfno.mse_loss(tfno.fno_forward(p, b["x"], cfg), b["y"]), {}),
        AdamWConfig(lr=1e-2),
    )

    def init_state():
        params = tfno.init_params(cfg, generator=torch.Generator().manual_seed(8), device="cpu")
        return {"params": params, "opt": init_opt_state(params)}

    def train_step(state, batch):
        p, o, m = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, m

    runs = {}
    for name, injector in (("clean", None), ("faulted", FaultInjector([3]))):
        res = run_supervised(
            init_state=init_state, train_step=train_step,
            batch_iter=lambda s: {k: v[s] for k, v in data.items()},
            total_steps=6, ckpt_dir=str(tmp_path / name), save_every=2,
            injector=injector, async_save=True,
        )
        assert [s for s, _ in res.metrics_log] == list(range(6))
        final, _, _ = tckpt.restore(str(tmp_path / name), {"params": tfno.param_shapes(cfg)})
        runs[name] = (res, final)
    assert (runs["faulted"][0].failures, runs["faulted"][0].restores) == (1, 1)
    assert (runs["clean"][0].failures, runs["clean"][0].restores) == (0, 0)
    for (name, a), (_, b) in zip(_leaves(runs["clean"][1]), _leaves(runs["faulted"][1])):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert [m for _, m in runs["clean"][0].metrics_log] == [m for _, m in runs["faulted"][0].metrics_log]


# ---------------------------------------------------------------------------
# the CLI against the reference's CLI
# ---------------------------------------------------------------------------

def _loss_line(out: str):
    line = next(ln for ln in out.splitlines() if ln.startswith("done: "))
    fields = line.split()
    a, b = fields[fields.index("loss") + 1], fields[fields.index("loss") + 3]
    return line, float(a), float(b)


@pytest.mark.timeout(600)
def test_cli_matches_jax_cli_and_both_runners_serve_its_checkpoint(tmp_path, monkeypatch, capsys):
    """Same stores, same initial params (the reference's PRNGKey(0) init,
    crossed over through numpy): the port's CLI on the CPU and the JAX CLI
    with --use-pallas print the same losses; the port's checkpoint then
    serves through both FNORunners with the same outputs."""
    grid = (8, 8, 4, 4)
    _write_stores(str(tmp_path / "ds"), 4, grid, seed=9)
    common = ["--mode", "fno", "--steps", "4", "--batch", "2", "--grad-accum", "2",
              "--width", "4", "--lr", "1e-2", "--save-every", "2", "--use-pallas",
              "--x-store", str(tmp_path / "ds" / "x"), "--y-store", str(tmp_path / "ds" / "y")]

    monkeypatch.setattr(sys, "argv", ["train.py"] + common + ["--ckpt-dir", str(tmp_path / "jck")])
    jtrain_cli.main()
    _, ja, jb = _loss_line(capsys.readouterr().out)

    jcfg = jtrain_cli.FNOConfig(grid=grid, modes=(2, 2, 2, 2), width=4, n_blocks=4,
                                decoder_dim=32, use_pallas=True)
    jparams = _jax_params(jcfg, 0)
    monkeypatch.setattr(ttrain_cli, "init_params",
                        lambda cfg, generator, device: tfno.params_from_numpy(jparams, device))
    res = ttrain_cli.main(common + ["--ckpt-dir", str(tmp_path / "tck"), "--device", "cpu"])
    line, ta, tb = _loss_line(capsys.readouterr().out)
    assert "steps=4 failures=0 restores=0" in line
    assert res.final_step == 4
    assert ta == pytest.approx(ja, rel=1e-4) and tb == pytest.approx(jb, rel=1e-4)

    with open(tmp_path / "tck" / "fno_config.json") as f, \
            open(tmp_path / "jck" / "fno_config.json") as g:
        assert json.load(f) == json.load(g)
    trunner = FNORunner.from_checkpoint(str(tmp_path / "tck"), device="cpu", max_slots=1)
    jrunner = JRunner.from_checkpoint(str(tmp_path / "tck"), max_slots=1)
    assert trunner.restored_step == jrunner.restored_step == 3
    x = np.random.default_rng(9).standard_normal((1,) + grid).astype(np.float32)
    outs = []
    for sched_cls, req_cls, runner in ((JScheduler, JRequest, jrunner),
                                       (Scheduler, ScenarioRequest, trunner)):
        sched = sched_cls(runner, 1)
        sched.submit(req_cls(rid=0, x=x.copy(), steps=1))
        done = sched.run_until_done(max_steps=10)
        assert not sched.failed and len(done) == 1
        outs.append(done[0].outputs[0])
    _close(outs[1], outs[0])


def test_cli_needs_a_card_or_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain_cli.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("flags,item", [
    (["--mode", "lm"], "item 5"),
    (["--online"], "item 4"),
    (["--devices", "2"], "item 2"),
    (["--model-shards", "2", "2"], "item 2"),
], ids=["lm", "online", "devices", "model-shards"])
def test_cli_refuses_what_is_not_ported(flags, item, tmp_path):
    with pytest.raises(SystemExit, match=f"ROADMAP Queue 1 {item}"):
        ttrain_cli.main(flags + ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
