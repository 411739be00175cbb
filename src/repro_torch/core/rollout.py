"""Vectorized executor/actor rollout (one synchronization interval).

Counterpart of ``repro/core/rollout.py``. ``rollout_interval`` advances
``n_envs`` replicas ``alpha`` steps under a fixed behavior policy and
returns the trajectory the learner consumes. Actions are sampled with
executor-derived keys (``core.determinism``), so they are a pure function
of (seed, env id, step). ``env_offset`` shifts the env ids used for
those keys; transition keys use ``env_id + 1_000_003``.

``width`` (the sharded runtime's global env count) runs the actor on a
batch of that many rows, the local envs at rows ``env_offset..`` and
zeros elsewhere, each row under its global env id's key: on the H100
cuBLAS and cuDNN choose their kernels by shape, so a row's logits
depend on the batch width (any width from 1 to 32 differs from 64
there), never on the row's position or on the other rows. At the
global width every env's action and logprob are the 1-process run's.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

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


def _zeros_in_layout(x, width: int):
    """Zeros of ``x``'s shape with ``width`` rows, laid out in memory in
    ``x``'s dimension order (an env's reset obs may come strided): the
    batch the 1-process run's actor reads has the same strides, and the
    CPU's convolutions take another path for other strides."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    shape = (width,) + tuple(x.shape[1:])
    out = x.new_zeros([shape[d] for d in order])
    return out.permute([order.index(d) for d in range(x.dim())])


def rollout_interval(policy_apply: Callable, env, params, env_state,
                     obs, master_key, start_step: int, cfg: RolloutConfig,
                     env_offset: int = 0, width: Optional[int] = None):
    """Returns (traj, env_state', obs').

    traj = {obs, actions (int32), rewards, dones, behavior_logprob (fp32):
    (alpha, n_envs, ...), bootstrap_obs: (n_envs, ...)}."""
    dev = master_key.device
    env_ids = env_offset + torch.arange(cfg.n_envs, dtype=torch.int64,
                                        device=dev)
    padded = width is not None and width != cfg.n_envs
    if padded:
        rows = slice(env_offset, env_offset + cfg.n_envs)
        actor_ids = torch.arange(width, dtype=torch.int64, device=dev)
    else:
        actor_ids = env_ids
    cols = {k: [] for k in ("obs", "actions", "rewards", "dones",
                            "behavior_logprob")}
    for t in range(cfg.alpha):
        gstep = start_step + t
        keys = determinism.obs_keys(master_key, actor_ids, gstep)
        if padded:
            batch = _zeros_in_layout(obs, width)
            batch[rows] = obs
            actions, blp = actor_forward(policy_apply, params, batch, keys)
            actions, blp = actions[rows], blp[rows]
        else:
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
