"""Fault tolerance: supervised training with checkpoint/restart, injected
failures for testing, and a straggler watchdog.

Port of ``repro.train.fault`` with the same state machine: a step that
raises (a worker dying mid-step, or an injected fault) rewinds to the latest
published checkpoint and replays from the step after it; the metrics log is
truncated to the restored step so replayed steps are not logged twice; at
most one asynchronous save is in flight. Where the reference blocks until
the step's arrays are ready, the port synchronises the card, so the
watchdog times real device work.

The training state is a nested dict of tensors. Restores load the
checkpoint into a fresh ``init_state()`` in place
(``checkpoint.restore_into``), which serves as the shapes and dtypes the
reference takes from ``jax.eval_shape``.

Across ranks (a ``StateLayout``) every rank runs the supervisor on its
shard of the state: the steps, the saves (each a collective gather that
rank 0 writes) and an injected fault fall on the same step everywhere,
and after a failure every rank waits at a barrier until rank 0 has
published its last save, so all restore the same checkpoint.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_leaves
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import StateLayout


class FaultInjector:
    """Raises at configured steps, once each (simulated node failures)."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected fault at step {step}")


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than ``threshold`` x the running median."""

    threshold: float = 2.0
    history: List[float] = dataclasses.field(default_factory=list)
    flagged: List[tuple] = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        self.history.append(seconds)
        n = len(self.history)
        if n < 5:
            return False
        median = sorted(self.history)[n // 2]
        if seconds > self.threshold * median:
            self.flagged.append((step, seconds, median))
            return True
        return False


@dataclasses.dataclass
class SupervisorResult:
    final_step: int
    failures: int
    restores: int
    metrics_log: list
    straggler_steps: list


def _synchronize(state) -> None:
    """Wait for the device work behind ``state`` (the reference's
    ``block_until_ready``)."""
    devices = {t.device for t in tree_leaves(state) if isinstance(t, torch.Tensor)}
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _restored(init_state, ckpt_dir, shards: dict):
    state = init_state()
    step, _ = ckpt_lib.restore_into(ckpt_dir, state, **shards)
    return state, step


def run_supervised(
    *,
    init_state: Callable[[], Any],          # () -> state tree
    train_step: Callable[[Any, Any], Any],  # (state, batch) -> (state, metrics)
    batch_iter,                              # step -> batch (restartable by step)
    total_steps: int,
    ckpt_dir: str,
    save_every: int = 10,
    max_failures: int = 8,
    injector: Optional[FaultInjector] = None,
    async_save: bool = False,
    layout: Optional[StateLayout] = None,
) -> SupervisorResult:
    """Train with checkpoint/restart. ``batch_iter(step)`` must return the
    batch for a given step so replays are deterministic after restore.
    With a ``layout`` every rank calls it with its shard of the state."""
    shards = {} if layout is None else {"parts": layout.state(), "groups": layout.groups}
    failures = 0
    restores = 0
    metrics_log = []
    watchdog = StragglerWatchdog()
    pending_save = None

    def _truncate_log(to_step: int):
        # a restore rewinds to ``to_step``; the rewound steps will be
        # re-executed and re-appended, so drop their old entries or the log
        # ends up with duplicate (step, metrics) pairs
        metrics_log[:] = [e for e in metrics_log if e[0] < to_step]

    if ckpt_lib.latest_step(ckpt_dir) is not None:
        state, step = _restored(init_state, ckpt_dir, shards)
        step += 1
        restores += 1
        _truncate_log(step)
    else:
        state = init_state()
        step = 0

    while step < total_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.time()
            state, metrics = train_step(state, batch_iter(step))
            _synchronize(state)
            watchdog.observe(step, time.time() - t0)
            metrics_log.append((step, {k: float(v) for k, v in metrics.items()}))
            if step % save_every == 0 or step == total_steps - 1:
                if pending_save is not None:
                    pending_save.join()  # one in-flight async save at a time
                _, pending_save = ckpt_lib.save(
                    ckpt_dir, step, state, async_save=async_save, **shards
                )
            step += 1
        except Exception:  # noqa: BLE001 — any worker failure
            failures += 1
            if failures > max_failures:
                raise
            if pending_save is not None:
                pending_save.join()
                pending_save = None
            if layout is not None:
                dist.barrier()  # rank 0's last save is published before any rank reads
            state = None  # drop the failed step's state before restoring
            if ckpt_lib.latest_step(ckpt_dir) is None:
                state = init_state()
                step = 0
            else:
                state, ck_step = _restored(init_state, ckpt_dir, shards)
                step = ck_step + 1
            _truncate_log(step)
            restores += 1

    if pending_save is not None:
        pending_save.join()
    return SupervisorResult(step, failures, restores, metrics_log, watchdog.flagged)
