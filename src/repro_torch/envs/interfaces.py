"""Environment interface: bundles of functions on tensors.

Counterpart of ``repro/envs/interfaces.py``. An ``Env`` is

    reset(key)               -> (state, obs)
    step(state, action, key) -> (state, obs, reward, done)

with ``key`` a threefry key (``core.determinism``, an int64 tensor (2,)).
``step`` auto-resets: when an episode ends, the returned state and obs
are already the first of the next episode and ``done`` is 1. The reset
key is ``fold_in(key, 7)``, as in the reference. Tensors are made on the
key's device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.core import determinism
from repro_torch.core.tree import tree_map


class Env(NamedTuple):
    name: str
    reset: Callable          # key -> (state, obs)
    step: Callable           # (state, action, key) -> (state, obs, r, done)
    obs_shape: Tuple[int, ...]
    n_actions: int
    # construction kwargs that travel with the env when
    # HTSConfig.env_backend='device' swaps it for its device port
    make_kwargs: Any = None


def with_autoreset(name, reset_fn, inner_step, obs_shape, n_actions,
                   make_kwargs=None) -> Env:
    """Wrap a raw step (that reports done without resetting) with
    auto-reset semantics."""

    def step(state, action, key):
        ns, obs, r, done = inner_step(state, action, key)
        rs, robs = reset_fn(determinism.fold_in(key, 7))
        state_out = tree_map(lambda a, b: torch.where(_bcast(done, a), b, a),
                             ns, rs)
        obs_out = torch.where(_bcast(done, obs), robs, obs)
        return state_out, obs_out, r, done

    return Env(name, reset_fn, step, obs_shape, n_actions,
               make_kwargs=make_kwargs)


def _bcast(done, x):
    """``done`` (a 0/1 float) as a bool mask broadcast over ``x``'s
    trailing dims."""
    mask = done != 0
    return mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))


def vectorize(env: Env, n: int) -> Env:
    """``n`` replicas of a scalar env (keys (n, 2), actions (n,)): the
    host oracle, ``torch.func.vmap`` of the scalar env's own functions."""
    return Env(
        name=f"{env.name}x{n}",
        reset=torch.func.vmap(env.reset, randomness="error"),
        step=torch.func.vmap(env.step, randomness="error"),
        obs_shape=env.obs_shape,
        n_actions=env.n_actions,
        make_kwargs=env.make_kwargs,
    )
