"""Training batches from chunked stores, and per-channel normalization.

The port's copy of ``repro.data.loader`` (that module imports JAX):
``NdArraySource``, ``Normalizer``, the background ``_Prefetcher`` and a
``ShardedDatasetLoader``. The sample schedule (``sample_ids``: per-epoch
permutations seeded by ``(seed, epoch)``), the normalization of ``"x"``
from the store's ``meta.json`` stats and the prefetch are the reference's,
so both loaders give the same batches from the same store; the port's are
torch tensors on the loader's device. Across ranks, a batch partition
(``core.fno.input_spec``) gives each rank its shard of the global batch:
its rows of the sample order and its x (and y) slices of every sample,
read from the store alone. ``StreamingSchedule`` draws batches from the
part of a store that datagen has finished (online training), the
reference's schedule; across ranks, rank 0 records each step's watermark
and every rank takes it from there.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device
from repro_torch.core.partition import CartPartition


class NdArraySource:
    """In-memory stand-in for an ArrayStore (synthetic-data path): exposes
    the same ``shape`` / ``read_slice`` / ``meta`` surface over an ndarray,
    so the loader's assembly and prefetch are exercised identically
    whether samples come from blob storage or RAM."""

    def __init__(self, array: np.ndarray, stats: Optional[dict] = None):
        self.array = np.asarray(array)
        self.shape = self.array.shape
        self.meta = {"stats": stats} if stats else {}

    def read_slice(self, slices: Sequence[slice]) -> np.ndarray:
        return self.array[tuple(slices)]


NORMALIZER_KINDS = ("meanstd", "absmax")


class Normalizer:
    """Invertible per-channel affine normalizer from persisted store stats.

    The ``normalizer`` kind in a store's ``meta.json`` selects the scheme:
    ``meanstd`` (default) encodes ``(x - mean) / std`` from the Welford
    stats; ``absmax`` encodes ``x / absmax``. ``decode`` inverts, which is
    what serving uses to return predictions in physical units. Stats arrays
    are shaped to broadcast over ``[b, c, *spatial]``.
    """

    def __init__(self, mean, scale, identity: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.scale = np.asarray(scale, np.float32)
        self.identity = identity

    @classmethod
    def from_stats(cls, stats, kind: str = "meanstd", ndim: int = 6) -> "Normalizer":
        if not stats:
            return cls(0.0, 1.0, identity=True)
        if kind not in NORMALIZER_KINDS:
            raise ValueError(
                f"unknown normalizer kind {kind!r}; expected one of "
                f"{NORMALIZER_KINDS}"
            )
        bshape = (1, -1) + (1,) * (ndim - 2)
        if kind == "absmax":
            if "absmax" not in stats:
                raise ValueError(
                    "normalizer 'absmax' requested but the persisted stats "
                    "carry no 'absmax' field (regenerate the store with the "
                    "current datagen, which tracks per-channel max|x|)"
                )
            mean = np.zeros(len(stats["absmax"]), np.float32).reshape(bshape)
            scale = np.maximum(
                np.asarray(stats["absmax"], np.float32).reshape(bshape), 1e-6
            )
        else:
            mean = np.asarray(stats["mean"], np.float32).reshape(bshape)
            scale = np.maximum(
                np.asarray(stats["std"], np.float32).reshape(bshape), 1e-6
            )
        return cls(mean, scale)

    @classmethod
    def from_source(cls, source) -> "Normalizer":
        meta = getattr(source, "meta", None) or {}
        return cls.from_stats(
            meta.get("stats"),
            meta.get("normalizer", "meanstd"),
            len(source.shape),
        )

    def encode(self, x: np.ndarray) -> np.ndarray:
        return np.asarray((x - self.mean) / self.scale, np.float32)

    def decode(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y * self.scale + self.mean, np.float32)


def _norm_params(source):
    """(mean, scale) broadcastable over [b, c, ...] or None, honoring the
    store's persisted ``normalizer`` kind."""
    n = Normalizer.from_source(source)
    return None if n.identity else (n.mean, n.scale)


class _Prefetcher:
    """Background producer of ``fetch(step)`` results, double-buffered.

    The producer runs ``depth`` steps ahead of the consumer. ``get(step)``
    normally pops a ready result; a non-sequential request (restart from a
    checkpointed step) resets the pipeline and computes synchronously once.

    One change from the reference's copy: a request counts as sequential
    only if the producer will really deliver it — it is the step in flight
    under the current generation, or the next step with room for it beside
    the step in flight. The reference's test (``step == _next - 1``, or
    ``step == _next`` with fewer than ``depth`` results ready) waits
    forever on a forward jump past ready results while one is in flight,
    and on a repeat of a step it just fetched synchronously after a reset.
    """

    def __init__(self, fetch, depth: int = 2):
        self._fetch = fetch
        self._depth = max(1, depth)
        self._lock = threading.Lock()
        self._ready: Dict[int, object] = {}
        self._cv = threading.Condition(self._lock)
        self._next = 0          # next step the producer should fetch
        self._gen = 0           # bumped on reset; stale results are dropped
        self._inflight = None   # step the producer fetches for this generation
        self._stopped = False
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            with self._cv:
                while not self._stopped and len(self._ready) >= self._depth:
                    self._cv.wait()
                if self._stopped:
                    return
                step, gen = self._next, self._gen
                self._next += 1
                self._inflight = step
            try:
                data = self._fetch(step)
            except BaseException as e:  # surface IO errors to the consumer
                with self._cv:
                    self._error = e
                    self._stopped = True
                    self._cv.notify_all()
                return
            with self._cv:
                if gen == self._gen:  # drop results from before a reset
                    self._ready[step] = data
                    self._inflight = None
                    self._cv.notify_all()

    def _restart(self, step: int):
        """Reset the pipeline to produce step+1 onwards (lock held). Clears
        a dead producer's error so one bad background fetch never poisons
        later steps — the caller fetches ``step`` synchronously, which
        re-raises with correct attribution if THIS step is the broken one."""
        self._gen += 1
        self._ready.clear()
        self._error = None
        self._next = step + 1
        self._inflight = None
        self._cv.notify_all()
        if self._stopped:
            self._stopped = False
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def get(self, step: int):
        with self._cv:
            if step in self._ready:
                data = self._ready.pop(step)
                self._cv.notify_all()
                return data
            # sequential requests keep the pipeline: the producer is either
            # computing this step or about to claim it (step == _next with
            # queue space beside the step in flight); anything else — an
            # out-of-order replay after restore, a forward jump, or a dead
            # producer — resets and fetches synchronously once.
            busy = len(self._ready) + (self._inflight is not None)
            sequential = (
                self._error is None
                and not self._stopped
                and (
                    step == self._inflight
                    or (step == self._next and busy < self._depth)
                )
            )
            if not sequential:
                self._restart(step)
        if not sequential:
            return self._fetch(step)
        with self._cv:
            while (
                step not in self._ready
                and not self._stopped
                and self._error is None
            ):
                self._cv.wait()
            if step in self._ready:
                data = self._ready.pop(step)
                self._cv.notify_all()
                return data
            self._restart(step)
        return self._fetch(step)

    def stop(self):
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._thread.join(timeout=5)


class StreamingSchedule:
    """Deterministic batch schedule over the currently-visible sample prefix.

    Online training (Meyer et al.: stream samples into training as the
    simulator produces them) needs a sample schedule that (a) only ever
    draws samples whose chunks are fully published, (b) blocks — with a
    stall counter surfaced in metrics — when training outpaces simulation,
    and (c) stays a pure replayable function of ``step`` after a checkpoint
    restore, which is the fault supervisor's contract.

    (c) is the subtle one: visibility is a race against the simulator, so
    the schedule RECORDS the complete-prefix watermark the first time each
    step is drawn (``watermark_log``). Batch ids are then a pure function of
    ``(seed, step, watermark_log[step])``; replaying the same log against
    the finished store — or after a crash restore, against the same run —
    reproduces every batch bit-identically. Pass ``log_path`` to persist the
    log (append-only jsonl, one entry per newly recorded step; a torn tail
    line from a crash is skipped) so a restarted process replays too. Note
    the log fixes the sample SCHEDULE; normalization stats are read once at
    loader construction, so a restarted process must reuse the same stats
    snapshot (``launch/train.py --online`` persists one next to this log)
    for the batch VALUES to match as well.

    Across ranks (``group``, every rank of it holding a schedule), the ranks
    must draw every step from one watermark, or the model shards of one
    batch would read different samples. ``agree(step)``, a collective that
    the training thread of every rank calls in step order, has the group's
    rank 0 record the step's watermark and broadcasts it; every rank
    records it and appends it to its own log. ``watermark`` then never runs
    a collective: on another thread (the loader's prefetch) it waits until
    ``agree`` has recorded the step. The port's counterpart of
    ``repro.data.loader.StreamingSchedule``; ``sample_ids`` draws the
    reference's ids bit for bit.
    """

    def __init__(
        self,
        stores: Sequence[object],
        batch_size: int,
        *,
        seed: int = 0,
        min_visible: Optional[int] = None,
        timeout: Optional[float] = None,
        poll_s: float = 0.02,
        watermark_log: Optional[Dict[int, int]] = None,
        log_path: Optional[str] = None,
        group=None,
    ):
        self.stores = list(stores)
        if not self.stores:
            raise ValueError("StreamingSchedule needs at least one store")
        self.batch_size = int(batch_size)
        self.seed = seed
        # back-pressure threshold: don't step until this many samples exist
        # (clamped to the smallest store so a batch larger than the dataset
        # oversamples the full prefix instead of waiting forever)
        cap = min(int(s.shape[0]) for s in self.stores)
        self.min_visible = max(
            1, min(min_visible if min_visible else batch_size, cap)
        )
        self.timeout = timeout
        self.poll_s = poll_s
        self.watermark_log: Dict[int, int] = {
            int(k): int(v) for k, v in (watermark_log or {}).items()
        }
        self.log_path = log_path
        if log_path and os.path.exists(log_path):
            with open(log_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn tail line from a crash mid-append
                    self.watermark_log[int(rec["step"])] = int(rec["w"])
        self.group = group
        self.stalls = 0
        self.stall_s = 0.0
        self._lock = threading.Lock()
        self._recorded = threading.Condition(self._lock)
        self._closed = False

    # -- visibility --------------------------------------------------------
    def visible_now(self) -> int:
        """Samples visible in EVERY store (min over complete prefixes)."""
        return min(s.complete_watermark() for s in self.stores)

    def _persist_entry(self, step: int, w: int) -> None:
        """Append one record — O(1) per step, unlike rewriting the dict."""
        if not self.log_path:
            return
        with open(self.log_path, "a") as f:
            f.write(json.dumps({"step": step, "w": w}) + "\n")

    def _record(self, step: int, w: int) -> None:
        """Record ``w`` for ``step`` (lock held) and wake its waiters."""
        self.watermark_log[step] = w
        self._persist_entry(step, w)
        self._recorded.notify_all()

    def _observe(self, step: int) -> int:
        """Visible-count watermark for ``step``: recorded once, replayed
        forever after. Blocks (back-pressure) while fewer than
        ``min_visible`` samples are published — WITHOUT holding the lock,
        so replay lookups of already-recorded steps from other threads
        (trainer vs prefetcher) never wait on the simulator."""
        while True:
            with self._lock:
                w = self.watermark_log.get(step)
                if w is not None:
                    return w
                w = self.visible_now()
                if w >= self.min_visible:
                    self._record(step, w)
                    return w
                self.stalls += 1
            t0 = time.monotonic()
            for s in self.stores:
                s.wait_for_samples(
                    self.min_visible, timeout=self.timeout, poll_s=self.poll_s
                )
            with self._lock:
                self.stall_s += time.monotonic() - t0

    def agree(self, step: int) -> int:
        """Across the group: rank 0's watermark for ``step``, recorded on
        every rank. A collective when the step is not yet recorded (the
        logs of all ranks are equal, so all ranks decide alike); call it
        on every rank's training thread, in step order. Without a group it
        is ``watermark``."""
        if self.group is None:
            return self.watermark(step)
        with self._lock:
            w = self.watermark_log.get(step)
        if w is not None:
            return w
        w = self._observe(step) if dist.get_rank(self.group) == 0 else 0
        t = torch.tensor([w], dtype=torch.int64)
        dist.broadcast(t, dist.get_global_rank(self.group, 0), group=self.group)
        w = int(t)
        with self._lock:
            if step not in self.watermark_log:
                self._record(step, w)
        return w

    def watermark(self, step: int) -> int:
        """The watermark of ``step``. Without a group, recorded on first use
        (``_observe``); with one, recorded by ``agree``, which this waits
        for."""
        if self.group is None:
            return self._observe(step)
        with self._lock:
            while step not in self.watermark_log:
                if self._closed:
                    raise RuntimeError(f"schedule closed before step {step} was agreed")
                self._recorded.wait()
            return self.watermark_log[step]

    def close(self) -> None:
        """Wake every thread waiting in ``watermark`` for an ``agree`` that
        will not come (it raises)."""
        with self._lock:
            self._closed = True
            self._recorded.notify_all()

    # -- the schedule itself ----------------------------------------------
    def sample_ids(self, step: int) -> np.ndarray:
        """Batch ids for ``step``: uniform over the visible prefix, pure in
        (seed, step, recorded watermark). Draws without replacement when the
        prefix is large enough, with replacement while it is still smaller
        than the batch (the price of starting before the data exists)."""
        w = self.watermark(step)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(step), int(w)])
        )
        return rng.choice(w, size=self.batch_size, replace=w < self.batch_size)

    def metrics(self) -> dict:
        with self._lock:
            return {
                "stalls": self.stalls,
                "stall_s": round(self.stall_s, 4),
                "max_step_recorded": max(self.watermark_log, default=-1),
                "last_watermark": self.watermark_log[
                    max(self.watermark_log)
                ] if self.watermark_log else 0,
            }


class ShardedDatasetLoader:
    """Training batches from chunked stores.

    ``sources`` maps batch keys to ArrayStore-like objects whose layout is
    ``[n_samples, channels, *spatial]``. ``batch(step)`` reads the samples
    of ``sample_ids(step)`` on the host (prefetched on a background thread),
    normalizes the keys in ``normalize``, and returns float32 tensors on
    ``device``.

    With ``part`` (the batch's ``CartPartition``, dim 0 the batch) and
    ``groups`` (its names' process groups), each key's batch is this rank's
    shard of the global batch, as the reference's per-device shard plan
    reads it: the rows of ``sample_ids(step)`` the data group gives this
    rank, each one read as the store slice under the rank's spatial shard
    (only the chunks it overlaps), normalized with the store's global
    stats. Without, the whole batch, each sample one read of its full
    extent. With ``schedule`` (a ``StreamingSchedule``), the sample ids of
    each step are the schedule's.
    """

    def __init__(
        self,
        sources: Dict[str, object],
        batch_size: int,
        *,
        device=None,
        seed: int = 0,
        shuffle: bool = True,
        normalize: Sequence[str] = ("x",),
        prefetch: int = 2,
        part: Optional[CartPartition] = None,
        groups=None,
        schedule: Optional[StreamingSchedule] = None,
    ):
        self.sources = dict(sources)
        self.schedule = schedule
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.shuffle = shuffle
        self._norm = {
            k: _norm_params(self.sources[k]) if k in tuple(normalize) else None
            for k in self.sources
        }
        ns = {s.shape[0] for s in self.sources.values()}
        if len(ns) != 1:
            raise ValueError(f"sources disagree on sample count: {ns}")
        self.n_samples = ns.pop()
        if self.n_samples < 1:
            raise ValueError("empty dataset")
        # each key's index of this rank's shard in the global batch; the
        # partition is validated here, so an indivisible layout fails fast
        self._index = {
            k: (tuple(slice(0, d) for d in (self.batch_size,) + tuple(s.shape[1:]))
                if part is None else
                part.index((self.batch_size,) + tuple(s.shape[1:]), groups))
            for k, s in self.sources.items()
        }
        self._prefetcher = (
            _Prefetcher(self._read_host_batch, depth=prefetch) if prefetch else None
        )

    def sample_ids(self, step: int) -> np.ndarray:
        """Sample ids of batch ``step``: a pure function of (seed, step); in
        streaming mode, the schedule's (of its watermark log)."""
        if self.schedule is not None:
            return self.schedule.sample_ids(step)
        n, b = self.n_samples, self.batch_size
        positions = np.arange(step * b, (step + 1) * b)
        epochs, offsets = positions // n, positions % n
        ids = np.empty(b, np.int64)
        for e in np.unique(epochs):
            if self.shuffle:
                perm = np.random.default_rng(
                    np.random.SeedSequence([self.seed, int(e)])
                ).permutation(n)
            else:
                perm = np.arange(n)
            sel = epochs == e
            ids[sel] = perm[offsets[sel]]
        return ids

    def _read(self, key: str, ids: np.ndarray) -> np.ndarray:
        """This rank's shard of ``key``'s batch: its rows of ``ids``, each a
        store read of its spatial slice only."""
        source = self.sources[key]
        rows, *rest = self._index[key]
        rows = ids[rows]
        out = np.empty((len(rows),) + tuple(sl.stop - sl.start for sl in rest), np.float32)
        for j, sample in enumerate(rows):
            out[j] = source.read_slice((slice(int(sample), int(sample) + 1),) + tuple(rest))[0]
        norm = self._norm.get(key)
        if norm is not None:
            mean, std = norm
            out = (out - mean[:, rest[0]]) / std[:, rest[0]]
        return np.ascontiguousarray(out, np.float32)

    def _read_host_batch(self, step: int):
        """Host arrays of batch ``step`` (IO thread)."""
        ids = self.sample_ids(step)
        return {"ids": ids, "blocks": {k: self._read(k, ids) for k in self.sources}}

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """Batch ``step`` on the loader's device (deterministic, prefetched)."""
        host = (
            self._prefetcher.get(step)
            if self._prefetcher is not None
            else self._read_host_batch(step)
        )
        return {
            k: torch.from_numpy(v).to(self.device) for k, v in host["blocks"].items()
        }

    def close(self):
        if self._prefetcher is not None:
            self._prefetcher.stop()
            self._prefetcher = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
