"""The baselines the paper compares against, in the same harness.

Counterpart of ``repro/core/baselines.py``:

* ``make_sync_step``  — A2C/PPO with the conventional alternating
  schedule (rollout, then an update at the same params; no delay, no
  overlap). HTS-RL's math minus the one-interval delay.
* ``make_async_step`` — GA3C/IMPALA-style stale-policy training: the
  behavior policy lags ``AsyncConfig.staleness`` updates behind the
  target (a FIFO of snapshots in the carry), with a correction in
  {none, epsilon, trunc_is, vtrace} (``algorithms.vtrace``).

Both are engine runtimes (``get_runtime("sync")``, ``"async"``). Their
gradient is ``torch.func.grad`` of the loss over the whole interval, as
the reference's ``jax.grad``: the per-env tree sum is the HTS family's
contract, not theirs. One interval runs on the current stream: the
update reads the rollout it follows, so there is nothing to overlap.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.algorithms import vtrace as vtrace_alg
from repro_torch.core import determinism
from repro_torch.core.engine import (HTSConfig, ScanRuntimeBase, TrainState,
                                     register_runtime)
from repro_torch.core.mesh_runtime import _interval_loss
from repro_torch.core.rollout import RolloutConfig, rollout_interval
from repro_torch.core.tree import tree_map
from repro_torch.envs.device import batched_env
from repro_torch.optim import Optimizer, apply_updates


def _init(params, env, cfg: HTSConfig, device):
    """(params copied to ``device``, env_state, obs): the env replicas
    reset from ``split(key(seed ^ 0x5EED), n_envs)``."""
    keys = determinism.split(
        determinism.master_key(cfg.seed ^ 0x5EED, device), cfg.n_envs)
    env_state, obs = env.reset(keys)
    return tree_map(lambda p: p.to(device, copy=True), params), env_state, obs


def make_sync_grad_fn(policy_apply: Callable, cfg: HTSConfig):
    """``grad(params, traj)`` of the interval loss: sync's learner."""
    return torch.func.grad(
        lambda p, traj: _interval_loss(policy_apply, p, traj, cfg)[0])


def make_sync_step(policy_apply: Callable, env, opt: Optimizer,
                   cfg: HTSConfig, device=None):
    """Conventional synchronous A2C/PPO interval (paper Fig. 2(c)):
    ``step(carry) -> (carry', metrics)``. ``device=None`` means ``cuda``,
    as for every builder here; without CUDA only an explicit ``"cpu"``
    runs."""
    device = resolve_device(device)
    rcfg = RolloutConfig(cfg.alpha, cfg.n_envs)
    master = determinism.master_key(cfg.seed, device)
    grad_fn = make_sync_grad_fn(policy_apply, cfg)

    def step(carry):
        params, opt_state, env_state, obs, j = carry
        traj, env_state, obs = rollout_interval(
            policy_apply, env, params, env_state, obs, master,
            int(j) * cfg.alpha, rcfg)
        grads = grad_fn(params, traj)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = {"rewards": traj["rewards"], "dones": traj["dones"]}
        return (params, opt_state, env_state, obs, j + 1), metrics

    return step


def sync_init_carry(params, opt: Optimizer, env, cfg: HTSConfig,
                    device=None):
    """(params, opt_state, env_state, obs, j = 0); ``params`` copied to
    ``device``, ``j`` an int32 tensor on the CPU (``TrainState``)."""
    params, env_state, obs = _init(params, env, cfg, resolve_device(device))
    return (params, opt.init(params), env_state, obs,
            torch.zeros((), dtype=torch.int32))


class AsyncConfig(NamedTuple):
    staleness: int = 8             # behavior policy lag in updates
    correction: str = "none"       # none | epsilon | trunc_is | vtrace
    epsilon: float = 1e-3          # GA3C's eps-correction
    rho_max: float = 1.0


def _stale_loss(policy_apply, params_target, traj, cfg: HTSConfig,
                acfg: AsyncConfig):
    """Eq. (5): the loss at theta_j on data from theta_{j-k}, with the
    chosen correction."""
    alg = vtrace_alg.make_correction(acfg)
    return alg.loss(policy_apply, params_target, traj, cfg)[0]


def make_async_grad_fn(policy_apply: Callable, cfg: HTSConfig,
                       acfg: AsyncConfig):
    """``grad(params, traj)`` of the stale loss: async's learner."""
    return torch.func.grad(
        lambda p, traj: _stale_loss(policy_apply, p, traj, cfg, acfg))


def make_async_step(policy_apply: Callable, env, opt: Optimizer,
                    cfg: HTSConfig, acfg: AsyncConfig, device=None):
    """Stale-policy actor-learner step: the rollout uses the params of
    ``acfg.staleness`` updates ago (the oldest snapshot of the FIFO in
    the carry), the learner differentiates the current params on it."""
    device = resolve_device(device)
    rcfg = RolloutConfig(cfg.alpha, cfg.n_envs)
    master = determinism.master_key(cfg.seed, device)
    grad_fn = make_async_grad_fn(policy_apply, cfg, acfg)

    def step(carry):
        params, opt_state, history, env_state, obs, j = carry
        behavior = tree_map(lambda h: h[0], history)
        traj, env_state, obs = rollout_interval(
            policy_apply, env, behavior, env_state, obs, master,
            int(j) * cfg.alpha, rcfg)
        grads = grad_fn(params, traj)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        history = tree_map(lambda h, p: torch.cat([h[1:], p[None]], dim=0),
                           history, params)
        metrics = {"rewards": traj["rewards"], "dones": traj["dones"]}
        return (params, opt_state, history, env_state, obs, j + 1), metrics

    return step


def async_init_carry(params, opt: Optimizer, env, cfg: HTSConfig,
                     acfg: AsyncConfig, device=None):
    """(params, opt_state, behavior FIFO, env_state, obs, j = 0): the
    FIFO holds ``acfg.staleness`` copies of the initial params."""
    params, env_state, obs = _init(params, env, cfg, resolve_device(device))
    history = tree_map(lambda p: torch.stack([p] * acfg.staleness), params)
    return (params, opt.init(params), history, env_state, obs,
            torch.zeros((), dtype=torch.int32))


# ---------------------------------------------------------------- engine
class _BaselineRuntime(ScanRuntimeBase):
    """Baseline carries lead with plain params (no DelayedGradState)."""

    def __init__(self, env, policy_apply: Callable, params,
                 opt: Optimizer, cfg: HTSConfig, device=None):
        super().__init__(env, policy_apply, params, opt, cfg, device)
        if cfg.staleness != 1:
            # the slab-ring staleness bound is an HTS-family knob: sync
            # has no delay and async takes AsyncConfig(staleness=...);
            # ignoring cfg.staleness would make sweep comparisons lie
            raise ValueError(
                f"{type(self).__name__} does not implement "
                f"HTSConfig.staleness={cfg.staleness}; sync is undelayed "
                f"and async takes AsyncConfig(staleness=...)")
        self.venv = batched_env(env, cfg.n_envs, cfg.env_backend)

    def _result_state(self, carry):
        return carry[0], carry


@register_runtime("sync")
class SyncRuntime(_BaselineRuntime):
    """Alternating rollout/update baseline (paper Fig. 2(c))."""

    name = "sync"

    def _build(self) -> None:
        self._step = make_sync_step(self.policy_apply, self.venv, self.opt,
                                    self.cfg, self.device)
        self.grad_fn = make_sync_grad_fn(self.policy_apply, self.cfg)

    def _initial_carry(self):
        return sync_init_carry(self.params0, self.opt, self.venv, self.cfg,
                               self.device)

    # sync consumes each interval at once: the capsule's buffer is empty
    def _carry_to_state(self, carry) -> TrainState:
        params, opt_state, env_state, obs, j = carry
        return TrainState((params, opt_state), env_state, obs, {}, j)

    def _state_to_carry(self, state: TrainState):
        params, opt_state = state.algo
        return (params, opt_state, state.env_state, state.obs,
                state.interval)


@register_runtime("async")
class AsyncRuntime(_BaselineRuntime):
    """Stale-policy baseline; pass ``acfg=AsyncConfig(...)`` or its fields
    as kwargs (not both) to set staleness and correction."""

    name = "async"

    def __init__(self, env, policy_apply, params, opt, cfg,
                 acfg: Optional[AsyncConfig] = None, device=None,
                 **acfg_kwargs):
        super().__init__(env, policy_apply, params, opt, cfg, device)
        if acfg is not None and acfg_kwargs:
            # with both forms the kwargs would be silently dropped:
            # AsyncRuntime(..., acfg=AsyncConfig(), staleness=16) would
            # run with staleness 8
            raise TypeError(
                f"pass either acfg=AsyncConfig(...) or AsyncConfig field "
                f"kwargs, not both (got acfg and {sorted(acfg_kwargs)})")
        self.acfg = acfg if acfg is not None else AsyncConfig(**acfg_kwargs)

    def _build(self) -> None:
        self._step = make_async_step(self.policy_apply, self.venv, self.opt,
                                     self.cfg, self.acfg, self.device)
        self.grad_fn = make_async_grad_fn(self.policy_apply, self.cfg,
                                          self.acfg)

    def _initial_carry(self):
        return async_init_carry(self.params0, self.opt, self.venv, self.cfg,
                                self.acfg, self.device)

    # the snapshot FIFO is part of the schedule: dropping it on resume
    # would reset the behavior lag and break run(a+b) == run(a) +
    # run_from(b)
    def _carry_to_state(self, carry) -> TrainState:
        params, opt_state, history, env_state, obs, j = carry
        return TrainState((params, opt_state, history), env_state, obs,
                          {}, j)

    def _state_to_carry(self, state: TrainState):
        params, opt_state, history = state.algo
        return (params, opt_state, history, state.env_state, state.obs,
                state.interval)
