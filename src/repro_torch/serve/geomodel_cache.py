"""Content-hash geomodel cache — the KV-cache of PDE serving.

(The port's own copy of ``repro.serve.geomodel_cache``, unchanged in
behaviour: importing the reference's would run ``repro.serve``'s package
imports, which load JAX.)

The paper's payoff workloads (well-placement optimization, UQ) run
thousands of scenarios against the *same* permeability geomodel: only the
well locations (and, across rollout steps, the saturation state) change.
Without a cache every request re-normalizes the geomodel channels and
re-lifts them through the encoder, per request AND per rollout step — the
PDE analogue of an LLM server re-prefilling a shared prompt prefix for
every completion.

This module caches the geomodel-dependent intermediates keyed by a content
hash of the RAW static channels, as a MULTI-LEVEL entry (shallow -> deep):

  * ``normalized``    — the static channels after the store's persisted
    per-channel normalization (what ingress would recompute per request);
  * ``prelift``       — their pre-activation encoder lift
    (``core.fno.encoder_prelift``), the reusable prefix of the split
    forward;
  * ``spectra``       — the truncated kept-mode spectrum of the static
    first hidden state S(GELU(prelift + b)) (``core.fno.spectral_prelift``);
  * ``contribution``  — its first-block weight mix W_0 . S(h_static), the
    term summed straight into the dynamic remainder's pre-activation by
    ``fno_forward_deep_split``.

Each level is derived from the previous one, so the LRU may drop the DEEP
levels of a cold entry (freeing the complex64 tensors) while keeping the
shallow ones — a deep re-miss then recomputes only the spectral prefix,
not the normalization. Eviction (full or deep-only) never mutates an entry
a caller already holds: deep-stripping replaces the stored entry with a
copy, so slots serving an in-flight rollout keep their levels. Counters
(hits/misses/evictions/deep_evictions/bytes, per-level bytes) feed the
serving CLIs' hit-rate reports; lookups happen once per slot per scheduler
tick, so the hit-rate reflects reuse across requests AND rollout steps.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional

import numpy as np

#: Cache levels, shallow to deep. The deep suffix is what deep-eviction drops.
LEVELS = ("normalized", "prelift", "spectra", "contribution")
DEEP_LEVELS = ("spectra", "contribution")

_HASH_CHUNK_ROWS_BYTES = 4 << 20


def content_key(arr: np.ndarray) -> str:
    """Content hash of an array's dtype + shape + raw bytes.

    dtype and shape are part of the digest, so a reshaped or reinterpreted
    buffer can never collide with the original. Contiguous arrays are fed
    to blake2b directly via the buffer protocol (zero copy); non-contiguous
    ones are hashed in bounded leading-axis slabs instead of one full
    ``tobytes()`` copy — the digest equals the contiguous-copy digest
    because C-order bytes concatenate along the leading axis.
    """
    a = np.asarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    if a.size:
        if a.flags["C_CONTIGUOUS"]:
            h.update(a)
        elif a.ndim == 0:
            h.update(a.tobytes())
        else:
            row_bytes = max(1, a.nbytes // max(1, a.shape[0]))
            rows = max(1, _HASH_CHUNK_ROWS_BYTES // row_bytes)
            for s in range(0, a.shape[0], rows):
                h.update(np.ascontiguousarray(a[s:s + rows]))
    return h.hexdigest()


@dataclasses.dataclass
class GeomodelEntry:
    """Cached intermediates for one geomodel (one static-channel content).

    The deep levels are optional: prelift-level serving never computes
    them, and deep-eviction strips them from the cache's copy.
    """

    key: str
    normalized: np.ndarray  # [c_static, *grid] encoded static channels
    prelift: np.ndarray     # [width, *grid] their encoder pre-activation lift
    spectra: Optional[np.ndarray] = None       # [width, 2mx, 2my, 2mz, mt] c64
    contribution: Optional[np.ndarray] = None  # [width, 2mx, 2my, 2mz, mt] c64

    @property
    def nbytes(self) -> int:
        return sum(self.level_bytes.values())

    @property
    def level_bytes(self) -> dict:
        return {
            name: (0 if getattr(self, name) is None else getattr(self, name).nbytes)
            for name in LEVELS
        }

    @property
    def has_deep(self) -> bool:
        return self.spectra is not None or self.contribution is not None

    def without_deep(self) -> "GeomodelEntry":
        """A copy with the deep levels dropped (the original is untouched,
        so in-flight holders keep theirs)."""
        return dataclasses.replace(self, spectra=None, contribution=None)


class GeomodelCache:
    """LRU cache of ``GeomodelEntry`` under a byte budget.

    Eviction is two-stage: the LRU entry first loses its deep levels
    (``deep_evictions``), and is only fully evicted (``evictions``) once
    already shallow. Byte accounting uses sizes recorded at put-time, so
    callers that grow an entry's levels in place must re-``put`` it.
    """

    def __init__(self, max_bytes: int = 256 << 20):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = max_bytes
        self._entries: "OrderedDict[str, GeomodelEntry]" = OrderedDict()
        self._sizes: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.deep_evictions = 0
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: str) -> Optional[GeomodelEntry]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)  # MRU
        self.hits += 1
        return entry

    def put(self, key: str, entry: GeomodelEntry) -> GeomodelEntry:
        """Insert (or refresh) an entry, then evict LRU-first until the
        byte budget holds. An entry larger than the whole budget is evicted
        immediately — the budget is strict; callers keep their reference."""
        if self._entries.pop(key, None) is not None:
            self.bytes -= self._sizes.pop(key)
        self._entries[key] = entry
        self._sizes[key] = entry.nbytes
        self.bytes += entry.nbytes
        self._evict()
        return entry

    def _evict(self) -> None:
        while self.bytes > self.max_bytes and self._entries:
            key = next(iter(self._entries))
            lru = self._entries[key]
            if lru.has_deep:
                stripped = lru.without_deep()
                delta = self._sizes[key] - stripped.nbytes
                if delta > 0:
                    # Replace in place (same LRU position) with a deep-less
                    # copy; the old object — possibly held by a serving
                    # slot — keeps its levels.
                    self._entries[key] = stripped
                    self._sizes[key] = stripped.nbytes
                    self.bytes -= delta
                    self.deep_evictions += 1
                    continue
            del self._entries[key]
            self.bytes -= self._sizes.pop(key)
            self.evictions += 1

    def clear(self) -> None:
        self._entries.clear()
        self._sizes.clear()
        self.bytes = 0

    @property
    def stats(self) -> dict:
        lookups = self.hits + self.misses
        level_bytes = dict.fromkeys(LEVELS, 0)
        for entry in self._entries.values():
            for name, n in entry.level_bytes.items():
                level_bytes[name] += n
        return {
            "entries": len(self._entries),
            "bytes": self.bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "deep_evictions": self.deep_evictions,
            "hit_rate": self.hits / lookups if lookups else 0.0,
            "level_bytes": level_bytes,
        }
