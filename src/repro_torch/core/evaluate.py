"""The paper's evaluation protocol (Sec. 5, following Henderson et al.
2017 / Colas et al. 2018).

Counterpart of ``repro/core/evaluate.py``. Everything but
``evaluate_policy`` is numpy on the host and is copied from the
reference (the port imports nothing of ``repro``); ``evaluate_policy``
runs the episodes with the port's envs, policies and ``determinism``.

* ``final_metric``          — mean over the last ``n_episodes`` completed
  episodes (paper: 100 episodes = 10 episodes x last 10 policies).
* ``final_time_metric``     — final_metric at a wall-clock budget.
* ``required_time_metric``  — first time the running average of the most
  recent ``window`` completed episodes reaches ``target``.
* ``bootstrap_ci``          — percentile bootstrap CI over episode
  returns (paper: 10k resamples, 95%).
* ``ReturnStream``          — streaming episode returns across chunks and
  checkpoints (``core/trainer.py``).
* ``evaluate_policy``       — no-op-started greedy/sampled episodes.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import determinism
from repro_torch.core.tree import tree_leaves
from repro_torch.envs.interfaces import Env


def _episode_returns_loop(rewards, dones) -> np.ndarray:
    """O(T*N) Python-loop reference for episode_returns_from_stream —
    kept as the property-test oracle (tests/test_eval_protocol.py)."""
    r = np.asarray(rewards, np.float64)
    d = np.asarray(dones)
    acc = np.zeros(r.shape[1])
    out = []
    for t in range(r.shape[0]):
        acc += r[t]
        done_envs = np.nonzero(d[t] > 0)[0]
        for e in done_envs:
            out.append(acc[e])
            acc[e] = 0.0
    return np.asarray(out)


def _episode_returns_vec(r: np.ndarray, d: np.ndarray, acc: np.ndarray):
    """Vectorized core: (T, N) f64 rewards, (T, N) bool dones, (N,)
    carried per-env partial-episode accumulator. Returns (completed
    episode returns in completion order, updated accumulator)."""
    T, N = r.shape
    acc_in = np.asarray(acc, np.float64)
    if T == 0:
        return np.zeros(0, np.float64), acc_in.copy()
    cs = acc_in[None, :] + np.cumsum(r, axis=0)        # (T, N) inclusive
    t_idx, e_idx = np.nonzero(d)       # row-major == completion order
    vals = cs[t_idx, e_idx]            # cumulative total at each done
    acc_out = cs[-1].copy()
    if len(t_idx) == 0:
        return np.zeros(0, np.float64), acc_out
    # per-env episode return = cumulative at this done minus cumulative
    # at the env's previous done (0 for its first episode): group the
    # done events by env (time-sorted within a group), difference, then
    # scatter back to completion order
    order = np.lexsort((t_idx, e_idx))
    v, e = vals[order], e_idx[order]
    prev = np.empty_like(v)
    prev[1:] = v[:-1]
    first_of_env = np.ones(len(e), bool)
    first_of_env[1:] = e[1:] != e[:-1]
    prev[first_of_env] = 0.0
    out = np.empty_like(vals)
    out[order] = v - prev
    # envs that completed an episode carry only the post-last-done tail
    last_of_env = np.ones(len(e), bool)
    last_of_env[:-1] = e[1:] != e[:-1]
    acc_out[e[last_of_env]] = cs[-1][e[last_of_env]] - v[last_of_env]
    return out, acc_out


def episode_returns_from_stream(rewards, dones) -> np.ndarray:
    """(T, N) reward/done streams -> array of completed episode returns
    in completion order (row-major over time, then env). Vectorized;
    bit-equal to the loop reference (hypothesis-tested)."""
    r = np.asarray(rewards, np.float64)
    d = np.asarray(dones) > 0
    out, _ = _episode_returns_vec(r, d, np.zeros(r.shape[1]))
    return out


class ReturnStream:
    """Streaming episode returns for chunked/checkpointed training
    (core/trainer.py): feed (T, N) or (intervals, alpha, N) reward/done
    chunks in order; episodes spanning chunk (and therefore checkpoint)
    boundaries are counted exactly once, because the per-env
    partial-episode accumulator is carried across ``extend`` calls.
    Feeding a stream in any chunking yields the returns of the one-shot
    ``episode_returns_from_stream`` on the concatenation — bit-exactly
    for integer-valued rewards (catch/gridmaze/football all emit small
    integers, so the f64 cumsums are exact), and to float rounding
    (~1 ulp, from re-associating the accumulator sum at chunk
    boundaries) for arbitrary real rewards.

    ``state_dict``/``load_state_dict`` round-trip the carry through JSON
    so the trainer's checkpoints resume the evaluation protocol, not just
    the parameters. The serialized history is CAPPED at the
    ``max_saved_returns`` most-recent episodes (plus the lifetime count)
    so checkpoint metadata stays O(1) over arbitrarily long runs — the
    paper's final metric only ever looks at the last 100 episodes.
    """

    def __init__(self, n_envs: int, max_saved_returns: int = 10_000):
        self.n_envs = n_envs
        self.max_saved_returns = max_saved_returns
        self.acc = np.zeros(n_envs, np.float64)
        self._returns: list = []
        self._n_dropped = 0      # pre-resume episodes truncated from tail

    def extend(self, rewards, dones) -> np.ndarray:
        """Append a chunk; returns the episodes completed within it."""
        r = np.asarray(rewards, np.float64).reshape(-1, self.n_envs)
        d = np.asarray(dones).reshape(-1, self.n_envs) > 0
        out, self.acc = _episode_returns_vec(r, d, self.acc)
        self._returns.extend(out.tolist())
        return out

    @property
    def returns(self) -> np.ndarray:
        """Known returns in completion order (a resumed stream may have
        dropped all but the last ``max_saved_returns`` of its pre-resume
        history; ``n_total`` keeps the lifetime count)."""
        return np.asarray(self._returns, np.float64)

    @property
    def n_total(self) -> int:
        return self._n_dropped + len(self._returns)

    def final_metric(self, n_episodes: int = 100) -> float:
        """Paper Sec. 5 final metric over the stream so far."""
        if not self._returns:
            return float("nan")
        return float(self.returns[-n_episodes:].mean())

    def state_dict(self) -> dict:
        return {"n_envs": self.n_envs, "acc": self.acc.tolist(),
                "returns": list(self._returns[-self.max_saved_returns:]),
                "n_total": self.n_total}

    def load_state_dict(self, state: dict) -> "ReturnStream":
        if int(state["n_envs"]) != self.n_envs:
            raise ValueError(
                f"ReturnStream resumed with n_envs={self.n_envs} but the "
                f"checkpoint recorded {state['n_envs']}")
        self.acc = np.asarray(state["acc"], np.float64)
        self._returns = list(state["returns"])
        self._n_dropped = (int(state.get("n_total", len(self._returns)))
                           - len(self._returns))
        return self


def final_metric(rewards, dones, n_episodes: int = 100) -> float:
    eps = episode_returns_from_stream(rewards, dones)
    if len(eps) == 0:
        return float("nan")
    return float(eps[-n_episodes:].mean())


def final_time_metric(rewards, dones, step_times,
                      time_limit: float, n_episodes: int = 100) -> float:
    """step_times: per-row wall/virtual duration (T,). Truncate the stream
    at the cumulative time budget, then final_metric."""
    ct = np.cumsum(np.asarray(step_times, np.float64))
    cut = int(np.searchsorted(ct, time_limit, side="right"))
    return final_metric(np.asarray(rewards)[:cut],
                        np.asarray(dones)[:cut], n_episodes)


def required_time_metric(rewards, dones, step_times, target: float,
                         window: int = 100) -> float:
    """Seconds (same unit as step_times) until the running mean of the
    last ``window`` completed episodes first reaches ``target``; inf if
    never."""
    r = np.asarray(rewards, np.float64)
    d = np.asarray(dones)
    ct = np.cumsum(np.asarray(step_times, np.float64))
    acc = np.zeros(r.shape[1])
    recent: list = []
    for t in range(r.shape[0]):
        acc += r[t]
        for e in np.nonzero(d[t] > 0)[0]:
            recent.append(acc[e])
            acc[e] = 0.0
        if recent and np.mean(recent[-window:]) >= target:
            return float(ct[t])
    return float("inf")


def bootstrap_ci(samples: Sequence[float], n_boot: int = 10_000,
                 alpha: float = 0.05, seed: int = 0
                 ) -> Tuple[float, float, float]:
    """(mean, lo, hi) percentile bootstrap CI (paper: Facebook Bootstrapped
    settings — 10k resamples, 95%)."""
    x = np.asarray(samples, np.float64)
    if len(x) == 0:
        return float("nan"), float("nan"), float("nan")
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(x), size=(n_boot, len(x)))
    means = x[idx].mean(axis=1)
    return (float(x.mean()),
            float(np.percentile(means, 100 * alpha / 2)),
            float(np.percentile(means, 100 * (1 - alpha / 2))))


def evaluate_policy(policy_apply: Callable, params, env: Env,
                    n_episodes: int = 10, max_steps: int = 1000,
                    noop_max: int = 0, noop_action: int = 0,
                    greedy: bool = True, seed: int = 0) -> np.ndarray:
    """Run evaluation episodes (single env, sequential) on the params'
    device. The paper's Atari convention applies up to ``noop_max``
    no-op actions at episode start. Returns the per-episode returns."""
    device = tree_leaves(params)[0].device
    master = determinism.master_key(seed, device)
    out = []
    for ep in range(n_episodes):
        key = determinism.fold_in(master, ep)
        state, obs = env.reset(key)
        n_noop = int(determinism.randint(determinism.fold_in(key, 1), (),
                                         0, noop_max + 1)) if noop_max else 0
        ret = 0.0
        for t in range(max_steps):
            if t < n_noop:
                a = torch.tensor(noop_action, dtype=torch.int32,
                                 device=device)
            else:
                logits, _ = policy_apply(params, obs[None])
                if greedy:
                    a = torch.argmax(logits[0]).to(torch.int32)
                else:
                    a = determinism.sample_action(
                        determinism.obs_key(master, ep, t), logits[0]
                    ).to(torch.int32)
            state, obs, r, d = env.step(state, a,
                                        determinism.fold_in(key, 100 + t))
            ret += float(r)
            if float(d) > 0:
                break
        out.append(ret)
    return np.asarray(out)
