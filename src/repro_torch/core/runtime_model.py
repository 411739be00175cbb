"""A copy of ``repro/core/runtime_model.py`` (numpy and scipy).

Claim 1: expected runtime of batch-synchronized rollout (paper Sec. 4.2).

    E[T_total^{n,K}] ~= K/(n a) * ( g/b * (1 + (a-1)/(b F^{-1}(1-1/n)))
                                    + F^{-1}(1-1/n) ) + K c / n

where F^{-1} is the Gamma(a, b) inverse CDF and g the Euler–Mascheroni
constant. Also provides the discrete-event simulator used to verify the
approximation (Fig. 3(a,b)) and the empirical-vs-Gamma goodness-of-fit
check from appendix A.
"""
from __future__ import annotations

import numpy as np
from scipy import stats

EULER_GAMMA = 0.5772156649015329


def expected_runtime(K: int, n: int, alpha: int, beta: float,
                     c: float = 0.0, step_shape: float = 1.0) -> float:
    """Eq. (7). K states, n envs, sync every alpha steps; each step time
    ~ Gamma(step_shape, rate=beta) so the alpha-step sum is
    Gamma(alpha*step_shape, beta) (the paper's claim uses step_shape=1,
    i.e. exponential steps; step_shape controls per-step variance at a
    fixed mean when beta = step_shape / mean). Actor compute time c/step.
    """
    a = alpha * step_shape
    Finv = stats.gamma.ppf(1.0 - 1.0 / n, a=a, scale=1.0 / beta)
    em = (EULER_GAMMA / beta) * (1.0 + (a - 1.0) / (beta * Finv)) + Finv
    return (K / (n * alpha)) * em + K * c / n


def simulate_runtime(K: int, n: int, alpha: int, beta: float,
                     c: float = 0.0, seed: int = 0,
                     dist: str = "exp", step_shape: float = 1.0) -> float:
    """Discrete-event simulation of the synchronized rollout.

    Each of the n envs performs alpha steps per interval; the interval ends
    when the slowest env finishes (max over n of a sum of alpha step times);
    total = sum over K/(n*alpha) intervals. dist: 'exp' -> step ~ Exp(beta)
    (so the alpha-sum is Gamma(alpha, beta), matching the claim's
    assumption).
    """
    rng = np.random.default_rng(seed)
    n_intervals = max(1, K // (n * alpha))
    if dist == "exp":
        sums = rng.gamma(shape=alpha * step_shape, scale=1.0 / beta,
                         size=(n_intervals, n))
    elif dist == "uniform":
        steps = rng.uniform(0, 2.0 / beta, size=(n_intervals, n, alpha))
        sums = steps.sum(-1)
    else:
        raise ValueError(dist)
    return float(sums.max(axis=1).sum() + n_intervals * alpha * c)


def async_runtime(K: int, n: int, beta: float, c: float = 0.0,
                  seed: int = 0) -> float:
    """Fully asynchronous lower bound: no synchronization, each env streams
    independently; makespan = max over envs of its own K/n step times."""
    rng = np.random.default_rng(seed)
    per_env = K // n
    times = rng.gamma(shape=per_env, scale=1.0 / beta, size=n)
    return float(times.max() + per_env * c)


def staleness_pipeline_runtime(rollout_times, learner_times,
                               staleness: int) -> float:
    """Deterministic recursion for the staleness-K slab-ring pipeline
    (DESIGN.md §4): given per-interval rollout durations R_j and serial
    per-update learner durations L_j, the coordinator's schedule is

        t_end[j]  = max(t_end[j-1] + R_j, ready[j-K])     (the interval
                     ends when its rollout finishes AND the apply has
                     consumed the learner pass over interval j-K's data
                     — the two overlap; unconstrained for j < K)
        ready[i]  = max(ready[i-1], t_end[i]) + L_i       (serial learner
                     FIFO: pass i starts when its data exists and the
                     previous pass finished)

    and the segment completes when both the last rollout and the learner
    backlog drain: max(t_end[-1], ready[-1]). At K=1 this reproduces the
    paper's per-interval max(R, L) synchronization loss; as K grows the
    bound relaxes toward max(sum R, sum L) — the same frontier
    benchmarks/staleness_sweep.py measures with real threads. Larger K
    never predicts a slower schedule on the same traces (the constraint
    set only shrinks)."""
    R = np.asarray(rollout_times, np.float64)
    L = np.asarray(learner_times, np.float64)
    if R.shape != L.shape or R.ndim != 1:
        raise ValueError(f"per-interval traces must match: {R.shape} vs "
                         f"{L.shape}")
    K = int(staleness)
    if K < 1:
        raise ValueError(f"staleness must be >= 1, got {K}")
    t_end, ready = [], []
    for j in range(len(R)):
        t = (t_end[-1] if t_end else 0.0) + R[j]
        if j - K >= 0:
            t = max(t, ready[j - K])
        t_end.append(t)
        ready.append(max(ready[-1] if ready else 0.0, t) + L[j])
    return float(max(t_end[-1], ready[-1])) if len(R) else 0.0


def gamma_fit_pvalue(samples: np.ndarray) -> float:
    """Appendix A: Kolmogorov–Smirnov goodness-of-fit of interval times to
    a Gamma distribution (fitted shape/scale)."""
    a, loc, scale = stats.gamma.fit(samples, floc=0.0)
    return float(stats.kstest(samples, "gamma", args=(a, loc, scale)).pvalue)
