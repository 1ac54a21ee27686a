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
read from the store alone. ``StreamingSchedule`` (online training) comes
with the datagen slice.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

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
    extent.
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
    ):
        self.sources = dict(sources)
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
        """Sample ids of batch ``step``: a pure function of (seed, step)."""
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
