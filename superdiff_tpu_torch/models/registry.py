"""Model registry: name -> score-network class (port of
``superdiff_tpu/models/registry.py``; parity with
``cifar/models/utils.py:42-65``, ``register_model`` / ``get_model``), so
config-driven experiment code resolves architectures by string name. The
four built-in names map to the port's classes."""

from __future__ import annotations

from typing import Dict

_MODELS: Dict[str, type] = {}


def register_model(cls=None, *, name: str | None = None):
    def _register(c):
        key = name or c.__name__
        if key in _MODELS:
            raise ValueError(f"model already registered: {key}")
        _MODELS[key] = c
        return c

    return _register if cls is None else _register(cls)


def get_model(name: str) -> type:
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; registered: {sorted(_MODELS)}")
    return _MODELS[name]


def registered_models():
    return dict(_MODELS)


def _register_builtins():
    from .mlp import MLPScoreNet
    from .protein.ipa import IPAScoreNetwork
    from .sd.unet import SDUNet
    from .unet import ScoreUNet

    for n, c in [
        ("score-net", ScoreUNet),  # the reference's registered name (ddpm.py:41)
        ("mlp", MLPScoreNet),
        ("sd-unet", SDUNet),
        ("ipa", IPAScoreNetwork),
    ]:
        if n not in _MODELS:
            _MODELS[n] = c


_register_builtins()
