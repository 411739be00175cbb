"""Vectorized executor/actor rollout (one synchronization interval).

Counterpart of ``repro/core/rollout.py``. ``rollout_interval`` advances
``n_envs`` replicas ``alpha`` steps under a fixed behavior policy and
returns the trajectory the learner consumes. Actions are sampled with
executor-derived keys (``core.determinism``), so they are a pure function
of (seed, env id, step). ``env_offset`` shifts the env ids used for
those keys; transition keys use ``env_id + 1_000_003``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import determinism
from repro_torch.core.losses import take_action


class RolloutConfig(NamedTuple):
    alpha: int                 # synchronization interval (steps)
    n_envs: int


def actor_forward(policy_apply: Callable, params, obs, keys):
    """The actor computation for one batch of observations.

    obs: (n, ...); keys: (n, 2). Returns (actions (n,) int32,
    behavior_logprob (n,) fp32): the Gumbel-argmax sample and its fp32
    ``log_softmax``."""
    logits, _ = policy_apply(params, obs)
    actions = determinism.sample_action(keys, logits).to(torch.int32)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return actions, take_action(logp, actions)


def rollout_interval(policy_apply: Callable, env, params, env_state,
                     obs, master_key, start_step: int, cfg: RolloutConfig,
                     env_offset: int = 0):
    """Returns (traj, env_state', obs').

    traj = {obs, actions (int32), rewards, dones, behavior_logprob (fp32):
    (alpha, n_envs, ...), bootstrap_obs: (n_envs, ...)}."""
    env_ids = env_offset + torch.arange(cfg.n_envs, dtype=torch.int64,
                                        device=master_key.device)
    cols = {k: [] for k in ("obs", "actions", "rewards", "dones",
                            "behavior_logprob")}
    for t in range(cfg.alpha):
        gstep = start_step + t
        keys = determinism.obs_keys(master_key, env_ids, gstep)
        actions, blp = actor_forward(policy_apply, params, obs, keys)
        step_keys = determinism.obs_keys(master_key, env_ids + 1_000_003,
                                         gstep)
        env_state, next_obs, reward, done = env.step(env_state, actions,
                                                     step_keys)
        for k, v in (("obs", obs), ("actions", actions), ("rewards", reward),
                     ("dones", done), ("behavior_logprob", blp)):
            cols[k].append(v)
        obs = next_obs
    traj = {k: torch.stack(v) for k, v in cols.items()}
    traj["bootstrap_obs"] = obs
    return traj, env_state, obs
