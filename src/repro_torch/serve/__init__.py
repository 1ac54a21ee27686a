"""Serving: the slot scheduler, the geomodel cache and its fleet-shared
store, the FNO runner, the gateway over replicas and the LLM engine."""
from repro_torch.serve.cache_store import (
    CacheStore, DictCacheStore, FileCacheStore, open_cache_store,
)
from repro_torch.serve.engine import SERVABLE_FAMILIES, Engine, Request, TransformerRunner
from repro_torch.serve.fno_runner import (
    FNORunner, ScenarioRequest, default_feedback, link_replicas,
)
from repro_torch.serve.gateway import (
    POLICIES, Gateway, OpenLoopReport, ReplicaHandle, serve_open_loop,
)
from repro_torch.serve.geomodel_cache import GeomodelCache, GeomodelEntry, content_key
from repro_torch.serve.scheduler import ModelRunner, Scheduler

__all__ = [
    "POLICIES",
    "SERVABLE_FAMILIES",
    "CacheStore",
    "DictCacheStore",
    "Engine",
    "FNORunner",
    "FileCacheStore",
    "Gateway",
    "GeomodelCache",
    "GeomodelEntry",
    "ModelRunner",
    "OpenLoopReport",
    "ReplicaHandle",
    "Request",
    "ScenarioRequest",
    "Scheduler",
    "TransformerRunner",
    "content_key",
    "default_feedback",
    "link_replicas",
    "open_cache_store",
    "serve_open_loop",
]
