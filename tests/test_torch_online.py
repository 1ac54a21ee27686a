"""Online training on the port: ``StreamingSchedule``, the loader's
``schedule=`` and ``launch/train.py --online``, on the CPU.

``sample_ids`` is bit for bit the reference's for the same seed, step and
watermark (the small-prefix replacement case included). The cases of
``tests/test_streaming.py`` on the port: replay from the recorded log,
back-pressure stalls, the log surviving a restart (and a torn tail line),
a batch larger than the dataset, and a fault mid-generation under
``run_supervised``. Then the trainer: ``train --online --device cpu`` to
its end, its checkpoint served by ``serve_pde --verify --reference``, and
one ``--devices 4 --model-shards 2 2 --online`` run on CPU ranks in which
every rank logged the same watermarks (the ``--online`` refusals are in
``tests/test_torch_train.py``).
"""
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

from repro.data.loader import StreamingSchedule as JSchedule
from torch_dist_checks import one_launch_at_a_time
from repro_torch.data.loader import ShardedDatasetLoader, StreamingSchedule
from repro_torch.data.store import ArrayStore
from repro_torch.launch import serve_pde
from repro_torch.launch import train as ttrain_cli
from repro_torch.train.fault import FaultInjector, run_supervised

SHAPE = (8, 1, 4, 4, 2, 2)
CHUNKS = (1, 1, 2, 4, 2, 2)


def _sample(i: int) -> np.ndarray:
    return np.random.default_rng(1000 + i).normal(size=SHAPE[1:]).astype(np.float32)


def _writer(store: ArrayStore, order, delay_s: float = 0.0):
    """Background 'simulator': publish samples one by one in ``order``."""
    def run():
        for i in order:
            if delay_s:
                time.sleep(delay_s)
            store.write_sample(i, _sample(i))
    th = threading.Thread(target=run, daemon=True)
    th.start()
    return th


class _Visible:
    """A store whose complete prefix is fixed at ``w`` of ``n`` samples."""

    def __init__(self, w: int, n: int):
        self.w, self.shape = w, (n,)

    def complete_watermark(self) -> int:
        return self.w


@pytest.mark.parametrize("seed,batch,n,w", [
    (0, 2, 8, 8), (7, 4, 16, 5), (3, 4, 16, 2), (11, 5, 2, 2), (5, 1, 1, 1), (2, 8, 64, 33),
])
def test_sample_ids_are_bitwise_the_reference(seed, batch, n, w):
    mine = StreamingSchedule([_Visible(w, n)], batch, seed=seed, min_visible=1)
    ref = JSchedule([_Visible(w, n)], batch, seed=seed, min_visible=1)
    for step in range(12):
        np.testing.assert_array_equal(mine.sample_ids(step), ref.sample_ids(step))
    assert mine.watermark_log == ref.watermark_log


def test_streaming_schedule_draws_only_visible_and_replays(tmp_path):
    """Every batch is drawn from the then-visible prefix, and the recorded
    log replayed against the FINISHED store reproduces the run bit for
    bit."""
    store = ArrayStore.create(str(tmp_path / "x"), SHAPE, "f4", CHUNKS)
    th = _writer(store, range(SHAPE[0]), delay_s=0.03)
    sched = StreamingSchedule([store], batch_size=2, seed=7, poll_s=0.005)
    online_ids, online_batches = [], []
    with ShardedDatasetLoader({"x": store}, 2, device="cpu", normalize=(), prefetch=2,
                              schedule=sched) as loader:
        for step in range(10):
            online_batches.append(loader.batch(step)["x"])
            online_ids.append(sched.sample_ids(step))
    th.join(timeout=30)
    assert not th.is_alive()
    for step, ids in enumerate(online_ids):
        assert (ids < sched.watermark_log[step]).all(), (step, ids)
    replay = StreamingSchedule([store], batch_size=2, seed=7,
                               watermark_log=sched.watermark_log)
    with ShardedDatasetLoader({"x": store}, 2, device="cpu", normalize=(), prefetch=0,
                              schedule=replay) as loader2:
        for step in range(10):
            np.testing.assert_array_equal(replay.sample_ids(step), online_ids[step])
            assert torch.equal(loader2.batch(step)["x"], online_batches[step])


def test_streaming_schedule_backpressure_counts_stalls(tmp_path):
    store = ArrayStore.create(str(tmp_path / "x"), SHAPE, "f4", CHUNKS)
    sched = StreamingSchedule([store], batch_size=2, seed=0, poll_s=0.005, timeout=30.0)
    th = _writer(store, range(3), delay_s=0.05)
    ids = sched.sample_ids(0)  # must block until 2 samples exist
    th.join(timeout=30)
    assert sched.metrics()["stalls"] >= 1
    assert sched.metrics()["stall_s"] > 0
    assert (ids < sched.watermark_log[0]).all()


def test_streaming_schedule_log_survives_restart_and_a_torn_line(tmp_path):
    store = ArrayStore.create(str(tmp_path / "x"), SHAPE, "f4", CHUNKS)
    for i in range(3):
        store.write_sample(i, _sample(i))
    log = str(tmp_path / "watermarks.json")
    s1 = StreamingSchedule([store], batch_size=2, seed=3, log_path=log)
    first = [s1.sample_ids(t) for t in range(4)]
    for i in range(3, 8):
        store.write_sample(i, _sample(i))
    with open(log, "a") as f:
        f.write('{"step": 4, "w"')  # a crash mid-append
    s2 = StreamingSchedule([store], batch_size=2, seed=3, log_path=log)
    for t in range(4):
        np.testing.assert_array_equal(s2.sample_ids(t), first[t])
    s2.sample_ids(4)  # an unrecorded step observes the NEW visibility
    assert s2.watermark_log[4] == 8 and s1.watermark_log[0] == 3


def test_streaming_schedule_small_prefix_uses_replacement(tmp_path):
    store = ArrayStore.create(str(tmp_path / "x"), SHAPE, "f4", CHUNKS)
    store.write_sample(0, _sample(0))
    sched = StreamingSchedule([store], batch_size=4, seed=0, min_visible=1)
    ids = sched.sample_ids(0)
    assert len(ids) == 4 and (ids == 0).all()


def test_streaming_schedule_batch_larger_than_dataset_terminates(tmp_path):
    store = ArrayStore.create(str(tmp_path / "x"), (2,) + SHAPE[1:], "f4", CHUNKS)
    for i in range(2):
        store.write_sample(i, _sample(i))
    sched = StreamingSchedule([store], batch_size=5, seed=0, timeout=30.0)
    ids = sched.sample_ids(0)
    assert len(ids) == 5 and set(ids) <= {0, 1}
    assert sched.watermark_log[0] == 2


def test_a_closed_group_schedule_wakes_its_waiters():
    """With a group, ``watermark`` waits for ``agree``; ``close`` ends that
    wait (the loader's prefetch thread at the end of a run)."""
    sched = StreamingSchedule([_Visible(4, 4)], 2, group=object())
    err = []
    th = threading.Thread(target=lambda: err.append(pytest.raises(
        RuntimeError, sched.watermark, 0)))
    th.start()
    time.sleep(0.05)
    sched.close()
    th.join(timeout=10)
    assert not th.is_alive() and err


@pytest.mark.timeout(300)
def test_online_training_survives_kill_mid_generation(tmp_path):
    """The simulator is still writing, a fault kills training mid-run, and
    the restore replays the SAME sample schedule for the re-executed
    steps."""
    store = ArrayStore.create(str(tmp_path / "x"), SHAPE, "f4", CHUNKS)
    th = _writer(store, range(SHAPE[0]), delay_s=0.05)
    sched = StreamingSchedule([store], batch_size=2, seed=11, poll_s=0.005)
    seen = {}
    with ShardedDatasetLoader({"x": store}, 2, device="cpu", normalize=(), prefetch=2,
                              schedule=sched) as loader:

        def batch_iter(step):
            ids = sched.sample_ids(step)
            if step in seen:  # replay after restore: bit-identical
                np.testing.assert_array_equal(ids, seen[step])
            seen[step] = ids
            return loader.batch(step)

        def train_step(state, batch):
            m = batch["x"].mean()
            return {"w": state["w"] - 0.05 * (state["w"] - m)}, {"loss": (state["w"] - m) ** 2}

        res = run_supervised(init_state=lambda: {"w": torch.zeros(())}, train_step=train_step,
                             batch_iter=batch_iter, total_steps=12,
                             ckpt_dir=str(tmp_path / "ckpt"), save_every=4,
                             injector=FaultInjector([6]))
    th.join(timeout=30)
    assert res.final_step == 12 and res.failures == 1 and res.restores == 1
    steps = [s for s, _ in res.metrics_log]
    assert len(steps) == len(set(steps)) == 12
    assert all(np.isfinite(m["loss"]) for _, m in res.metrics_log)


ONLINE = ["--mode", "fno", "--online", "--n-data", "4", "--batch", "2", "--steps", "4",
          "--width", "8", "--grid", "8", "8", "4", "4", "--datagen-workers", "2",
          "--device", "cpu"]


def _online_line(out: str) -> dict:
    m = re.search(r"online: first step with (\d+)/(\d+) samples complete \(visible=(\d+)\) "
                  r"stalls=(\d+)", out)
    assert m, out
    return {"first": int(m[1]), "n": int(m[2]), "visible": int(m[3]), "stalls": int(m[4])}


def _logged(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_train_online_then_serve_with_reference(tmp_path, capsys):
    res = ttrain_cli.main(ONLINE + ["--out", str(tmp_path / "ds"),
                                    "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert "done: steps=4 failures=0 restores=0" in out and res.final_step == 4
    line = _online_line(out)
    assert line["n"] == 4 and 2 <= line["visible"] <= 4
    for name in ("x", "y"):
        store = ArrayStore.open(str(tmp_path / "ds" / name))
        assert store.n_complete() == 4 and "stats" in store.meta
    with open(tmp_path / "ck" / "stats_snapshot.json") as f, \
            open(tmp_path / "ck" / "fno_config.json") as g:
        assert json.load(g)["x_stats"] == json.load(f)
    logged = _logged(str(tmp_path / "ck" / "watermarks.json"))
    assert [e["step"] for e in logged][:4] == [0, 1, 2, 3]
    assert all(2 <= e["w"] <= 4 for e in logged)

    done = serve_pde.main(["--ckpt-dir", str(tmp_path / "ck"), "--scenarios", "2",
                           "--verify", "--reference", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(done) == 2 and "verify OK: 2 scenarios" in out
    m = re.search(r"reference simulator: ([\d.]+)s/scenario vs surrogate ([\d.]+)ms/scenario "
                  r"-> (\d+)x", out)
    assert m and float(m[1]) > 0 and float(m[2]) > 0, out


def test_train_online_on_4_ranks_logs_one_schedule(tmp_path, capsys):
    """Datagen runs once, in the launching process; every rank draws each
    step from rank 0's watermark (through an injected fault and its
    restore) and logs the same entries."""
    with one_launch_at_a_time():
        res = ttrain_cli.main(ONLINE + ["--out", str(tmp_path / "ds"), "--ckpt-dir",
                                        str(tmp_path / "ck"), "--devices", "4",
                                        "--model-shards", "2", "2", "--save-every", "2",
                                        "--inject-fault", "3", "--datagen-backend",
                                        "process"])
    out = capsys.readouterr().out
    assert "done: steps=4 failures=1 restores=1" in out and res.final_step == 4
    assert out.count("datagen: 4/4 samples complete") == 1
    _online_line(out)
    logs = [_logged(str(tmp_path / "ck" / name)) for name in
            ["watermarks.json"] + [f"watermarks.rank{r}.json" for r in (1, 2, 3)]]
    assert logs[0] and all(log == logs[0] for log in logs[1:])
    assert [e["step"] for e in logs[0]] == sorted({e["step"] for e in logs[0]})
