"""Serving: the slot scheduler, the geomodel cache, the FNO runner and the
LLM engine."""
from repro_torch.serve.engine import SERVABLE_FAMILIES, Engine, Request, TransformerRunner
from repro_torch.serve.fno_runner import FNORunner, ScenarioRequest, default_feedback
from repro_torch.serve.geomodel_cache import GeomodelCache, GeomodelEntry, content_key
from repro_torch.serve.scheduler import ModelRunner, Scheduler

__all__ = [
    "SERVABLE_FAMILIES",
    "Engine",
    "FNORunner",
    "GeomodelCache",
    "GeomodelEntry",
    "ModelRunner",
    "Request",
    "ScenarioRequest",
    "Scheduler",
    "TransformerRunner",
    "content_key",
    "default_feedback",
]
