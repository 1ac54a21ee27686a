"""Fleet-shared geomodel cache store — the disaggregated tier behind the
per-replica ``GeomodelCache``.

(The port's own copy of ``repro.serve.cache_store``, unchanged in
behaviour and in its ``.npz`` layout, so either package's
``FileCacheStore`` reads the other's entries: importing the reference's
would run ``repro.serve``'s package imports, which load JAX.)

Gateway replicas each keep a process-local LRU (``serve.geomodel_cache``),
but affinity routing re-pins a geomodel to a different replica after a
failover — and without a shared tier the new replica re-pays the full
static prefix (normalize + prelift + spectral prefix) that the failed
replica had already computed. This module is the serving-system pattern of
a disaggregated KV-cache store (rtp-llm's ``cache_store/``): a
content-hash-keyed, checkpoint-versioned store that replicas consult on
local miss and populate on fresh compute, so a geomodel warmed anywhere is
warm fleet-wide.

Two backends:

  * ``DictCacheStore`` — a shared in-process dict (replicas in one process,
    e.g. tests/benchmarks or threaded gateways); arrays are copied on both
    put and get so no caller can mutate a stored entry.
  * ``FileCacheStore`` — one ``.npz`` per (version, key) under a root
    directory; writes go to a temp file then ``os.replace`` so concurrent
    replica processes never observe a torn entry.

Versioning: entries are namespaced by a checkpoint+config signature
(``FNORunner.cache_version``) — a replica restored from a different
checkpoint, or configured with different modes/width, can never consume
another's intermediates.
"""
from __future__ import annotations

import os
import tempfile
import threading
from typing import Optional

import numpy as np

from repro_torch.serve.geomodel_cache import LEVELS, GeomodelEntry

#: Levels that every stored entry must carry (the shallow prefix).
_REQUIRED = ("normalized", "prelift")


def _entry_fields(entry: GeomodelEntry) -> dict:
    return {
        name: getattr(entry, name)
        for name in LEVELS
        if getattr(entry, name) is not None
    }


def _entry_from_fields(key: str, fields: dict) -> Optional[GeomodelEntry]:
    if any(name not in fields for name in _REQUIRED):
        return None
    return GeomodelEntry(
        key=key,
        normalized=np.asarray(fields["normalized"]),
        prelift=np.asarray(fields["prelift"]),
        spectra=None if "spectra" not in fields else np.asarray(fields["spectra"]),
        contribution=(
            None if "contribution" not in fields
            else np.asarray(fields["contribution"])
        ),
    )


class CacheStore:
    """Interface + shared counters. ``get``/``put`` take the version
    namespace explicitly so one store serves heterogeneous replicas."""

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.puts = 0

    def get(self, version: str, key: str) -> Optional[GeomodelEntry]:
        raise NotImplementedError

    def put(self, version: str, key: str, entry: GeomodelEntry) -> None:
        raise NotImplementedError

    @property
    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "puts": self.puts,
            "hit_rate": self.hits / lookups if lookups else 0.0,
        }


class DictCacheStore(CacheStore):
    """Shared-dict backend: replicas in the same process (threaded gateway,
    tests, benchmarks) share one instance. Entries are stored and returned
    as copies — the store can never alias a replica's live arrays."""

    def __init__(self):
        super().__init__()
        self._data: dict = {}
        self._lock = threading.Lock()

    def get(self, version: str, key: str) -> Optional[GeomodelEntry]:
        with self._lock:
            fields = self._data.get((version, key))
            if fields is None:
                self.misses += 1
                return None
            self.hits += 1
            return _entry_from_fields(key, {k: v.copy() for k, v in fields.items()})

    def put(self, version: str, key: str, entry: GeomodelEntry) -> None:
        fields = {k: v.copy() for k, v in _entry_fields(entry).items()}
        with self._lock:
            old = self._data.get((version, key))
            # Never replace a fuller entry with a shallower one: a
            # prelift-level replica must not strip the deep levels a
            # deep-level replica already published.
            if old is not None and set(fields) <= set(old):
                return
            self._data[(version, key)] = fields
            self.puts += 1

    @property
    def stats(self) -> dict:
        with self._lock:
            entries = len(self._data)
            nbytes = sum(
                v.nbytes for fields in self._data.values() for v in fields.values()
            )
        return {**super().stats, "entries": entries, "bytes": nbytes}


class FileCacheStore(CacheStore):
    """File backend: one ``.npz`` per entry at ``root/<version>/<key>.npz``.

    Writes land in a same-directory temp file first, then ``os.replace``
    (atomic on POSIX), so a concurrent reader in another replica process
    sees either the old entry or the new one — never a torn file. A
    corrupt/partial file (e.g. a crashed writer on a non-atomic
    filesystem) is treated as a miss and removed.
    """

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, version: str, key: str) -> str:
        return os.path.join(self.root, version, f"{key}.npz")

    def get(self, version: str, key: str) -> Optional[GeomodelEntry]:
        path = self._path(version, key)
        try:
            with np.load(path) as npz:
                fields = {name: npz[name] for name in npz.files}
        except FileNotFoundError:
            self.misses += 1
            return None
        except (OSError, ValueError, KeyError):
            try:
                os.remove(path)
            except OSError:
                pass
            self.misses += 1
            return None
        entry = _entry_from_fields(key, fields)
        if entry is None:
            self.misses += 1
            return None
        self.hits += 1
        return entry

    def put(self, version: str, key: str, entry: GeomodelEntry) -> None:
        fields = _entry_fields(entry)
        path = self._path(version, key)
        if os.path.exists(path):
            try:
                with np.load(path) as npz:
                    if set(fields) <= set(npz.files):
                        return  # existing entry is at least as deep
            except (OSError, ValueError):
                pass  # corrupt: fall through and rewrite
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **fields)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self.puts += 1

    @property
    def stats(self) -> dict:
        entries = 0
        nbytes = 0
        for dirpath, _dirnames, filenames in os.walk(self.root):
            for fn in filenames:
                if fn.endswith(".npz"):
                    entries += 1
                    try:
                        nbytes += os.path.getsize(os.path.join(dirpath, fn))
                    except OSError:
                        pass
        return {**super().stats, "entries": entries, "bytes": nbytes}


def open_cache_store(spec: str) -> CacheStore:
    """Build a store from a CLI spec: ``"dict"`` / ``"mem"`` for the shared
    in-process dict, anything else is a filesystem root."""
    if spec in ("dict", "mem", "dict://"):
        return DictCacheStore()
    return FileCacheStore(spec)
