"""Pluggable update algorithms (one copy of the math, every runtime).

Counterpart of ``repro/algorithms/__init__.py``:

    from repro_torch import algorithms
    alg = algorithms.get_algorithm("a2c")
    loss, stats = alg.loss(policy_apply, params, traj, cfg)

Importing this package registers the built-ins: a2c, ppo, vtrace,
epsilon, trunc_is.
"""
from repro_torch.algorithms.base import (  # noqa: F401
    Algorithm, algorithm_names, get_algorithm, register,
    advantages_and_returns, policy_on_traj)
from repro_torch.algorithms import a2c, ppo, vtrace  # noqa: F401
