"""Clusterless cloud batch layer (the paper's Redwood.jl, in Python): the
port's copy of ``repro.cloud``, which the port may not import."""
from repro_torch.cloud.api import BatchPool, remote, VM_PRICES, SPOT_DISCOUNT  # noqa: F401
from repro_torch.cloud.backend import (  # noqa: F401
    LocalProcessBackend,
    SimBackend,
    SimConfig,
    ThreadBackend,
)
from repro_torch.cloud.objectstore import BlobRef, ObjectStore  # noqa: F401
