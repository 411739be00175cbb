"""Device-resident environments: natively batched ports.

Counterpart of ``repro/envs/device/__init__.py``. A ``DeviceEnv`` steps
STACKED per-env state (every leaf has a leading ``n_envs`` axis) with
batched tensor ops, where ``interfaces.vectorize`` vmaps the scalar env.
The call signature is the vectorized env's:

    reset(keys)                  -> (state, obs)         keys: (n, 2)
    step(state, actions, keys)   -> (state, obs, r, done)

so the rollout consumes either. ``HTSConfig.env_backend`` picks one
(``batched_env``). The oracle contract: for every port,
``vectorize(host_env, n)`` and the port give bit-identical (state, obs,
reward, done) for identical (keys, actions), through auto-resets.
Registered ports: ``catch``, ``gridmaze``.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core import determinism
from repro_torch.core.tree import tree_map
from repro_torch.envs.interfaces import Env, _bcast, vectorize


class DeviceEnv(NamedTuple):
    """A natively batched env over stacked per-env state; field-compatible
    with ``interfaces.Env``. ``host_name`` names the host env it ports."""
    name: str
    reset: Callable          # keys (n, 2) -> (state, obs (n, ...))
    step: Callable           # (state, actions (n,), keys (n, 2)) -> 4-tuple
    obs_shape: Tuple[int, ...]
    n_actions: int
    host_name: str


def device_autoreset(name, reset_fn, inner_step, obs_shape, n_actions,
                     host_name) -> DeviceEnv:
    """Batched mirror of ``interfaces.with_autoreset``; the reset key is
    ``fold_in(key, 7)`` per row, as the host wrapper derives it."""

    def step(state, actions, keys):
        ns, obs, r, done = inner_step(state, actions, keys)
        rs, robs = reset_fn(determinism.fold_in(keys, 7))
        state_out = tree_map(lambda a, b: torch.where(_bcast(done, a), b, a),
                             ns, rs)
        obs_out = torch.where(_bcast(done, obs), robs, obs)
        return state_out, obs_out, r, done

    return DeviceEnv(name, reset_fn, step, obs_shape, n_actions, host_name)


# ------------------------------------------------------------- registry
_REGISTRY: Dict[str, Callable[..., DeviceEnv]] = {}

# host env name -> (module, factory attribute), imported on first lookup
_LAZY: Dict[str, tuple] = {
    "catch": ("repro_torch.envs.device.catch", "make"),
    "gridmaze": ("repro_torch.envs.device.gridmaze", "make"),
}


def has_device_port(host_name: str) -> bool:
    return host_name in _REGISTRY or host_name in _LAZY


def device_port_names() -> list:
    """Host env names that have a device-resident port."""
    return sorted(set(_REGISTRY) | set(_LAZY))


def get_device_env(host_name: str, **kwargs) -> DeviceEnv:
    """Construct the device port of a host env by the host env's name;
    raises, listing the ports, for an env without one."""
    if host_name not in _REGISTRY and host_name in _LAZY:
        module, attr = _LAZY[host_name]
        _REGISTRY[host_name] = getattr(importlib.import_module(module), attr)
    try:
        factory = _REGISTRY[host_name]
    except KeyError:
        raise ValueError(
            f"env {host_name!r} has no device-resident port; "
            f"env_backend='device' supports {device_port_names()} "
            f"(use env_backend='host' for the rest)") from None
    return factory(**kwargs)


def batched_env(env: Env, n_envs: int, backend: str = "host"):
    """The one place ``HTSConfig.env_backend`` is read: ``"host"`` vmaps
    the scalar env (the oracle), ``"device"`` takes its registered port.
    Fails here, at runtime construction, for an unknown backend or an env
    without a port."""
    if backend == "host":
        return vectorize(env, n_envs)
    if backend == "device":
        return get_device_env(env.name, **(env.make_kwargs or {}))
    raise ValueError(
        f"unknown env_backend {backend!r}; choose 'host' (vmapped "
        f"scalar envs) or 'device' (device-resident batched port)")
