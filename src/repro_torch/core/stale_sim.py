"""A copy of ``repro/core/stale_sim.py`` (numpy only).

Claim 2: expected behavior/target policy latency of asynchronous
actor-learner systems (GA3C / IMPALA) — M/M/1 queue analysis + simulator.

    E[L] = n*rho0 / (1 - n*rho0),   rho0 = lambda0 / mu

HTS-RL's latency is identically 1 regardless of actor count (the double
buffer admits exactly one outstanding interval).
"""
from __future__ import annotations

import numpy as np


def expected_latency(n_actors: int, lam0: float, mu: float) -> float:
    rho = n_actors * lam0 / mu
    if rho >= 1.0:
        return float("inf")
    return rho / (1.0 - rho)


def simulate_latency(n_actors: int, lam0: float, mu: float,
                     horizon: float = 2000.0, seed: int = 0):
    """Event-driven M/M/1: n_actors Poisson producers (aggregate rate
    n*lam0), one exponential consumer (rate mu). Returns the mean queue
    length seen by consumed items ≈ policy lag in updates."""
    rng = np.random.default_rng(seed)
    t, q = 0.0, 0
    next_arrival = rng.exponential(1.0 / (n_actors * lam0))
    next_service = np.inf
    lags = []
    while t < horizon:
        if next_arrival <= next_service:
            t = next_arrival
            q += 1
            if q == 1:
                next_service = t + rng.exponential(1.0 / mu)
            next_arrival = t + rng.exponential(1.0 / (n_actors * lam0))
        else:
            t = next_service
            lags.append(q - 1)     # items still ahead when this one leaves
            q -= 1
            next_service = (t + rng.exponential(1.0 / mu)) if q > 0 else np.inf
    return float(np.mean(lags)) if lags else 0.0


def hts_latency(n_actors: int) -> int:
    """HTS-RL: constant, by construction (see core/delayed_grad.py)."""
    return 1
