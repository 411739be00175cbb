"""The ``Algorithm`` protocol: the update math, apart from scheduling.

Counterpart of ``repro/algorithms/base.py``. Every runtime drives

    loss(policy_apply, params, traj, cfg) -> (scalar, LossStats)

on the interval trajectory of ``core.rollout.rollout_interval``
(time-major ``(alpha, n_envs, ...)`` leaves plus ``bootstrap_obs``).
Algorithms are pure functions of tensors, so ``torch.func`` can
differentiate and vmap them.
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, Tuple, runtime_checkable

import torch

from repro_torch.core import losses


@runtime_checkable
class Algorithm(Protocol):
    name: str

    def loss(self, policy_apply: Callable, params, traj, cfg
             ) -> Tuple[torch.Tensor, losses.LossStats]:
        """Scalar training loss (and stats) for one interval trajectory."""
        ...


_REGISTRY: Dict[str, Algorithm] = {}


def register(alg: Algorithm) -> Algorithm:
    _REGISTRY[alg.name] = alg
    return alg


def get_algorithm(name: str) -> Algorithm:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown algorithm {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def algorithm_names():
    return sorted(_REGISTRY)


def policy_on_traj(policy_apply, params, traj):
    """Forward the policy over an interval trajectory: (logits (A, N,
    n_actions), values (A, N), bootstrap_value (N,), detached)."""
    A, N = traj["actions"].shape
    obs = traj["obs"]
    logits, values = policy_apply(params, obs.reshape((A * N,) + obs.shape[2:]))
    _, bv = policy_apply(params, traj["bootstrap_obs"])
    return logits.reshape(A, N, -1), values.reshape(A, N), bv.detach()


def advantages_and_returns(values, bootstrap_value, traj, cfg):
    """(advantages, returns) per cfg.use_gae / cfg.gae_lambda / cfg.gamma."""
    if getattr(cfg, "use_gae", False):
        return losses.gae(traj["rewards"], traj["dones"], values.detach(),
                          bootstrap_value, cfg.gamma, cfg.gae_lambda)
    rets = losses.n_step_returns(traj["rewards"], traj["dones"],
                                 bootstrap_value, cfg.gamma)
    return rets - values.detach(), rets
