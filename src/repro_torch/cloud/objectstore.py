"""Blob object store: the substrate of Redwood's broadcast/fetch.

The port's copy of ``repro.cloud.objectstore``, with two changes. Each
thread keeps its own zstd compressor and decompressor, as the port's chunk
store does (``data/store.py``): the reference shares one of each between
the thread backend's workers and the caller fetching results, which
zstandard does not allow ("Data corruption detected", "Destination buffer
is too small"). And a blob's temporary file is named for its process and
thread, so two threads of one process putting the same content
(speculative duplicates on the thread backend) never write one file.

Redwood serializes ASTs/arguments to Azure Blob storage and passes
references; workers deserialize on their side. Here: pickled blobs (zstd)
on a shared filesystem root, addressed by content-hash keys — broadcast is
"put once, pass the BlobRef to every task"."""
from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import threading
from typing import Any

try:
    import zstandard as zstd
except ImportError:  # pragma: no cover
    zstd = None

_ZSTD = threading.local()


def _compress(raw: bytes) -> bytes:
    if zstd is None:
        return raw
    if not hasattr(_ZSTD, "c"):
        _ZSTD.c = zstd.ZstdCompressor(level=3)
    return _ZSTD.c.compress(raw)


def _decompress(raw: bytes) -> bytes:
    if zstd is None:
        return raw
    if not hasattr(_ZSTD, "d"):
        _ZSTD.d = zstd.ZstdDecompressor()
    return _ZSTD.d.decompress(raw)


@dataclasses.dataclass(frozen=True)
class BlobRef:
    root: str
    key: str
    nbytes: int

    def fetch(self) -> Any:
        return ObjectStore(self.root).get(self)


class ObjectStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def put(self, obj: Any) -> BlobRef:
        raw = _compress(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        key = hashlib.sha1(raw).hexdigest()[:24]
        path = os.path.join(self.root, key)
        if not os.path.exists(path):  # content-addressed: dedup free
            tmp = path + f".tmp{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(raw)
            os.rename(tmp, path)
        return BlobRef(self.root, key, len(raw))

    def get(self, ref: BlobRef) -> Any:
        with open(os.path.join(self.root, ref.key), "rb") as f:
            raw = f.read()
        return pickle.loads(_decompress(raw))
