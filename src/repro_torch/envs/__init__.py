"""Environment registry: ``get_env(name, **kwargs)``.

Counterpart of ``repro/envs/__init__.py``. Registered: ``catch`` and
``gridmaze`` (host envs) and ``catch_device`` and ``gridmaze_device``
(their batched ports, which specs normally reach through
``HTSConfig.env_backend="device"``; ``envs.device`` resolves a host
env's port), ``token`` (next-token prediction as an MDP) and
``token_stream`` (``data.pipeline.TokenStream``, the workload of the
``stream`` runtime). ``football`` is not ported yet (ROADMAP queue 1).
Built-ins load on first lookup; an unknown
name raises ``KeyError`` listing the names.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}

# name -> (module, factory attribute), imported on first lookup
_LAZY: Dict[str, tuple] = {
    "catch": ("repro_torch.envs.catch", "make"),
    "gridmaze": ("repro_torch.envs.gridmaze", "make"),
    "catch_device": ("repro_torch.envs.device.catch", "make"),
    "gridmaze_device": ("repro_torch.envs.device.gridmaze", "make"),
    "token": ("repro_torch.envs.token_env", "make"),
    # the batched token source of the ``stream`` runtime, not an Env
    "token_stream": ("repro_torch.data.pipeline", "TokenStream"),
}


def get_env_factory(name: str) -> Callable[..., Any]:
    """Resolve an environment factory by registry name."""
    if name not in _REGISTRY and name in _LAZY:
        module, attr = _LAZY[name]
        _REGISTRY[name] = getattr(importlib.import_module(module), attr)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown env {name!r}; "
                       f"registered: {env_names()}") from None


def get_env(name: str, **kwargs):
    """Construct a registered environment: ``get_env("catch")``."""
    return get_env_factory(name)(**kwargs)


def env_names():
    return sorted(set(_REGISTRY) | set(_LAZY))

