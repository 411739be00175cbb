"""Environment registry: ``get_env(name, **kwargs)``.

Counterpart of ``repro/envs/__init__.py``. Registered: ``catch`` and
``gridmaze`` (host envs) and ``catch_device`` and ``gridmaze_device``
(their batched ports, which specs normally reach through
``HTSConfig.env_backend="device"``; ``envs.device`` resolves a host
env's port), ``token`` (next-token prediction as an MDP) and
``token_stream`` (``data.pipeline.TokenStream``, the workload of the
``stream`` runtime) and ``football`` (the mini-football drill; its
multi-player variant is ``football.make_multi``). Built-ins load on first
lookup; an unknown name raises ``KeyError`` listing the names. Third
parties add entries with ``@register_env``, as in the reference.
``has_device_port`` and ``get_device_env`` reach ``envs.device`` by a
host env's name.
"""
from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_REGISTRY: Dict[str, Callable[..., Any]] = {}

# name -> (module, factory attribute), imported on first lookup
_LAZY: Dict[str, tuple] = {
    "catch": ("repro_torch.envs.catch", "make"),
    "gridmaze": ("repro_torch.envs.gridmaze", "make"),
    "football": ("repro_torch.envs.football", "make"),
    "catch_device": ("repro_torch.envs.device.catch", "make"),
    "gridmaze_device": ("repro_torch.envs.device.gridmaze", "make"),
    "token": ("repro_torch.envs.token_env", "make"),
    # the batched token source of the ``stream`` runtime, not an Env
    "token_stream": ("repro_torch.data.pipeline", "TokenStream"),
}


def register_env(name: str):
    """Factory decorator: ``@register_env("my_env")`` over a
    ``(**kwargs) -> Env`` callable."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


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


def has_device_port(name: str) -> bool:
    """Does host env ``name`` have a device-resident port
    (``HTSConfig.env_backend="device"``)? See ``envs.device``."""
    from repro_torch.envs import device
    return device.has_device_port(name)


def get_device_env(name: str, **kwargs):
    """Construct the device-resident port of host env ``name``; raises
    ``ValueError`` listing the ports when there is none."""
    from repro_torch.envs import device
    return device.get_device_env(name, **kwargs)
