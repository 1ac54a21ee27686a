"""Serving: the slot scheduler, the geomodel cache and the FNO runner."""
from repro_torch.serve.fno_runner import FNORunner, ScenarioRequest, default_feedback
from repro_torch.serve.geomodel_cache import GeomodelCache, GeomodelEntry, content_key
from repro_torch.serve.scheduler import ModelRunner, Scheduler

__all__ = [
    "FNORunner",
    "GeomodelCache",
    "GeomodelEntry",
    "ModelRunner",
    "ScenarioRequest",
    "Scheduler",
    "content_key",
    "default_feedback",
]
