"""Name -> model constructor registry (what ``--model=`` resolves
through), the reference's names and errors."""

from __future__ import annotations

from typing import Any, Callable, Dict

_MODELS: Dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    def deco(ctor):
        _MODELS[name] = ctor
        return ctor
    return deco


def get_model(name: str, **kwargs):
    try:
        ctor = _MODELS[name]
    except KeyError:
        raise KeyError(f"unknown model {name!r}; have {sorted(_MODELS)}") from None
    return ctor(**kwargs)


def model_names():
    return sorted(_MODELS)
