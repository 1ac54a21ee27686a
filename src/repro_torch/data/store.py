"""Chunked N-D array store (zarr-style) on a filesystem "object store".

The port's own copy of ``repro.data.store`` (importing that module runs
``repro/data/__init__.py``, which imports JAX). It differs in one place:
without the ``zstandard`` package, chunks are written raw, and reading a
compressed chunk raises a clear error instead of returning its compressed
bytes as data. It also keeps one zstd context per thread: a zstandard
compressor or decompressor must not be used by two threads at once, and
``read_slice`` decompresses on a pool of threads (the reference's shared
decompressor corrupts chunks or crashes there).

The paper writes each simulated training pair to blob storage with Zarr and
has every GPU read only its spatial chunk during training. This store
reproduces those two properties without external deps:

  * disjoint parallel writes: each worker writes whole chunks — chunk files
    are independent objects, so thousands of simulation tasks can write
    concurrently with no coordination;
  * partial reads: a training process reads only the chunks overlapping its
    shard's slice (model-parallel input loading).

Format: <root>/meta.json + <root>/c<idx0>_<idx1>_... (zstd-compressed raw).
Writes are atomic (tmp + rename) so interrupted tasks can be retried safely
— the idempotency the spot-VM story relies on. ``meta.json`` may carry
extra persisted keys (e.g. the datagen CLI's normalization ``stats``) via
``update_meta``.

IO accounting: every ``read_chunk`` bumps ``io_counters`` (chunk count,
logical bytes, compressed bytes on disk), which is how the loader tests
prove each shard touches only the chunks overlapping its slice.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence, Tuple

import numpy as np

# Multi-chunk read_slice fans file IO + decompression out over this many
# threads (chunks are independent objects; blob-store reads are latency-
# bound, so a small pool overlaps them well without oversubscribing CPU).
READ_POOL_WORKERS = 8

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

try:
    import zstandard as zstd

    _ZSTD = threading.local()

    def _compress(b):
        if not hasattr(_ZSTD, "c"):
            _ZSTD.c = zstd.ZstdCompressor(level=3)
        return _ZSTD.c.compress(b)

    def _decompress(b, nbytes, path):
        if not hasattr(_ZSTD, "d"):
            _ZSTD.d = zstd.ZstdDecompressor()
        return _ZSTD.d.decompress(b)

except ImportError:
    def _compress(b):
        return b

    def _decompress(b, nbytes, path):
        if len(b) != nbytes:
            kind = "zstd-compressed" if b[:4] == _ZSTD_MAGIC else "not a raw chunk"
            raise RuntimeError(
                f"chunk file {path} holds {len(b)} bytes for {nbytes} bytes of "
                f"data ({kind}); reading a compressed store needs the "
                f"'zstandard' package, which is not installed"
            )
        return b


class ArrayStore:
    def __init__(self, root: str, shape, dtype, chunks, meta: dict | None = None):
        self.root = root
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.chunks = tuple(chunks)
        assert len(self.chunks) == len(self.shape)
        self.meta = dict(meta) if meta else {}
        self.io_counters = {"chunks_read": 0, "bytes_read": 0, "bytes_on_disk": 0}
        self._io_lock = threading.Lock()  # keeps io_counters exact under the pool
        self._pool: ThreadPoolExecutor | None = None
        self._watermark = 0  # complete-prefix length last observed (monotone)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def create(cls, root: str, shape, dtype, chunks) -> "ArrayStore":
        os.makedirs(root, exist_ok=True)
        meta = {"shape": list(shape), "dtype": np.dtype(dtype).str, "chunks": list(chunks)}
        tmp = os.path.join(root, "meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.rename(tmp, os.path.join(root, "meta.json"))
        return cls(root, shape, dtype, chunks, meta)

    @classmethod
    def open(cls, root: str) -> "ArrayStore":
        with open(os.path.join(root, "meta.json")) as f:
            meta = json.load(f)
        return cls(root, meta["shape"], meta["dtype"], meta["chunks"], meta)

    def update_meta(self, **extra) -> None:
        """Persist extra metadata keys (atomic rewrite of meta.json)."""
        self.meta.update(extra)
        merged = {
            "shape": list(self.shape),
            "dtype": self.dtype.str,
            "chunks": list(self.chunks),
            **{k: v for k, v in self.meta.items() if k not in ("shape", "dtype", "chunks")},
        }
        tmp = os.path.join(self.root, f"meta.json.tmp{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.rename(tmp, os.path.join(self.root, "meta.json"))
        self.meta = merged

    # -- chunk io ----------------------------------------------------------
    def _chunk_path(self, idx: Sequence[int]) -> str:
        return os.path.join(self.root, "c" + "_".join(str(i) for i in idx))

    def chunk_grid(self) -> Tuple[int, ...]:
        return tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))

    def _chunk_shape(self, idx: Sequence[int]) -> Tuple[int, ...]:
        return tuple(
            min(self.chunks[d], self.shape[d] - idx[d] * self.chunks[d])
            for d in range(len(idx))
        )

    def write_chunk(self, idx: Sequence[int], data: np.ndarray):
        expected = self._chunk_shape(idx)
        assert data.shape == expected, (data.shape, expected)
        path = self._chunk_path(idx)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(_compress(np.ascontiguousarray(data.astype(self.dtype)).tobytes()))
        os.rename(tmp, path)  # atomic publish -> retried tasks are safe

    def read_chunk(self, idx: Sequence[int]) -> np.ndarray:
        shape = self._chunk_shape(idx)
        path = self._chunk_path(idx)
        try:
            with open(path, "rb") as f:
                raw_disk = f.read()
        except FileNotFoundError:
            raise FileNotFoundError(
                f"chunk {tuple(idx)} of store {self.root!r} is missing "
                f"(expected file {path}); the sample was never written or "
                f"its datagen task is still in flight"
            ) from None
        raw = _decompress(raw_disk, int(np.prod(shape)) * self.dtype.itemsize, path)
        out = np.frombuffer(raw, dtype=self.dtype).reshape(shape)
        with self._io_lock:
            self.io_counters["chunks_read"] += 1
            self.io_counters["bytes_read"] += out.nbytes
            self.io_counters["bytes_on_disk"] += len(raw_disk)
        return out

    def has_chunk(self, idx: Sequence[int]) -> bool:
        return os.path.exists(self._chunk_path(idx))

    def reset_io_counters(self) -> None:
        self.io_counters = {"chunks_read": 0, "bytes_read": 0, "bytes_on_disk": 0}

    # -- convenience: leading-dim samples + arbitrary slices ---------------
    def sample_chunk_indices(self, i: int) -> Iterator[Tuple[int, ...]]:
        """All chunk indices in leading-dim chunk row i (== sample i when
        chunks[0] == 1, the one-sim-result-per-task layout)."""
        grid = self.chunk_grid()
        return (
            (i,) + rest
            for rest in itertools.product(*[range(g) for g in grid[1:]])
        )

    def sample_complete(self, i: int) -> bool:
        """True iff every chunk of sample i has been published."""
        return all(self.has_chunk(idx) for idx in self.sample_chunk_indices(i))

    def write_sample(self, i: int, data: np.ndarray):
        """Write sample i when chunks[0] == 1 (one sim result per task).

        The sample may span several spatial chunks (the store's chunking
        along x/y is what lets each training shard read only its pencil);
        each chunk file is published atomically, so a retried task simply
        overwrites whatever subset its predecessor managed to write.
        """
        assert self.chunks[0] == 1
        if data.ndim == len(self.shape) - 1:
            data = data[None]
        assert data.shape == (1,) + self.shape[1:], (data.shape, self.shape)
        for idx in self.sample_chunk_indices(i):
            sel = (slice(0, 1),) + tuple(
                slice(idx[d] * self.chunks[d], idx[d] * self.chunks[d] + s)
                for d, s in list(enumerate(self._chunk_shape(idx)))[1:]
            )
            self.write_chunk(idx, data[sel])

    def read_slice(self, slices: Sequence[slice]) -> np.ndarray:
        """Read an arbitrary rectangular slice (touches only needed chunks).

        Only unit-step slices are supported; the chunk-copy math below
        assumes contiguous ranges, so a stepped slice would silently return
        wrong data — reject it instead.
        """
        slices = tuple(
            slice(*sl.indices(self.shape[d])) for d, sl in enumerate(slices)
        )
        for d, sl in enumerate(slices):
            if sl.step != 1:
                raise ValueError(
                    f"read_slice supports only unit-step slices; got step "
                    f"{sl.step} in dim {d} of {self.root!r}"
                )
        out_shape = tuple(sl.stop - sl.start for sl in slices)
        out = np.empty(out_shape, self.dtype)
        lo = [sl.start // c for sl, c in zip(slices, self.chunks)]
        hi = [(sl.stop - 1) // c for sl, c in zip(slices, self.chunks)]
        indices = list(
            itertools.product(*[range(a, b + 1) for a, b in zip(lo, hi)])
        )

        def copy_one(idx):
            # chunks are independent objects and each writes a DISJOINT
            # rectangle of ``out``, so the copies can run concurrently;
            # read_chunk keeps io_counters exact under its lock
            chunk = self.read_chunk(idx)
            src, dst = [], []
            for d in range(len(idx)):
                c0 = idx[d] * self.chunks[d]
                s0 = max(slices[d].start, c0)
                s1 = min(slices[d].stop, c0 + chunk.shape[d])
                src.append(slice(s0 - c0, s1 - c0))
                dst.append(slice(s0 - slices[d].start, s1 - slices[d].start))
            out[tuple(dst)] = chunk[tuple(src)]

        if len(indices) == 1:
            copy_one(indices[0])
        else:
            for f in [self._read_pool().submit(copy_one, i) for i in indices]:
                f.result()  # re-raises missing-chunk errors with attribution
        return out

    def _read_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=READ_POOL_WORKERS,
                thread_name_prefix="arraystore-read",
            )
        return self._pool

    def n_complete(self) -> int:
        return sum(
            1 for i in range(self.chunk_grid()[0]) if self.sample_complete(i)
        )

    # -- visibility (online/streaming training) ----------------------------
    def complete_watermark(self) -> int:
        """Length of the complete PREFIX of samples: the largest w such that
        samples 0..w-1 are all published.

        Incremental: chunk publishes are atomic and never retracted, so a
        sample observed complete stays complete — each call resumes the scan
        at the last known watermark instead of re-polling every chunk file
        (O(new samples) per call, not O(n * chunks)). A streaming reader can
        therefore poll this cheaply while datagen is still writing.
        """
        n = self.chunk_grid()[0]
        w = self._watermark
        while w < n and self.sample_complete(w):
            w += 1
        self._watermark = w
        return w

    def wait_for_samples(
        self, k: int, timeout: float | None = None, poll_s: float = 0.02
    ) -> int:
        """Block until the complete prefix reaches ``k`` samples (or the full
        store, if smaller); returns the watermark. Raises TimeoutError if
        ``timeout`` seconds pass first — a stuck simulator should fail the
        training job loudly, not hang it."""
        target = min(int(k), self.chunk_grid()[0])
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            w = self.complete_watermark()
            if w >= target:
                return w
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(
                    f"store {self.root!r}: waited {timeout}s for {target} "
                    f"complete samples, have {w}"
                )
            time.sleep(poll_s)
