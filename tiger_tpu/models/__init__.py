"""Physics models (DummyModel, Model204) and the uid -> model registry.

Equivalent of the reference model registry
(src/model_registry.{hpp,cpp}): instead of cudaMemcpyToSymbol-ing a Parameters
struct into constant memory, models are plain frozen dataclasses closed over by
the jitted solver, and solver tolerances travel as a SolverConfig.
"""

from __future__ import annotations

from tiger_tpu.models.base import Model
from tiger_tpu.models.dummy import DummyModel
from tiger_tpu.models.model200 import Model200
from tiger_tpu.models.model204 import Model204, PARAM_FIELDS, Y0_COMMON

_REGISTRY = {
    DummyModel.UID: DummyModel,
    Model200.UID: Model200,
    Model204.UID: Model204,
}


def register_model(cls) -> None:
    """Register a model class under its UID (reference model_registry.cpp:18-53)."""
    _REGISTRY[cls.UID] = cls


def get_model(uid: int, **kwargs) -> Model:
    """Instantiate the model registered under ``uid``.

    ``kwargs`` are passed through when the model's dataclass declares the
    field (e.g. ``doy0`` for Model 200's start-date-anchored day of year) and
    silently dropped otherwise, so the driver can offer them uniformly.
    """
    try:
        cls = _REGISTRY[uid]
    except KeyError:
        raise KeyError(f"No model registered with uid {uid}; known: {sorted(_REGISTRY)}")
    import dataclasses

    names = {f.name for f in dataclasses.fields(cls)} if dataclasses.is_dataclass(cls) else set()
    return cls(**{k: v for k, v in kwargs.items() if k in names})


__all__ = [
    "Model",
    "DummyModel",
    "Model200",
    "Model204",
    "PARAM_FIELDS",
    "Y0_COMMON",
    "get_model",
    "register_model",
]
