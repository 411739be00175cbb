"""Open-loop Poisson load generator for a PolicyServer session.

Counterpart of ``repro/serve/loadgen.py``. Open loop: arrivals follow
their own clock whatever the completions, so queueing delay shows up in
the latency numbers instead of throttling the load. Request i's latency
runs from its SCHEDULED arrival to the resolution of its future.

Deterministic: arrival gaps come from a seeded numpy generator,
observations from the env's reset under seeded keys, and request seeds
are the request index, so a replay replays the action stream.

With ``retry > 0`` submissions use ``submit(block=False)`` and an
``Overloaded`` shed is retried up to ``retry`` times with exponential
backoff and seeded jitter. Requests shed with a typed error are counted,
not crashed on; the latency numbers cover the answered requests.
``repro_torch.launch.serve --spec`` wraps ``run``.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core import determinism
from repro_torch.envs.interfaces import vectorize


def reset_obs(env, n: int, seed: int) -> np.ndarray:
    """``n`` observations of ``env``'s reset, under
    ``split(master_key(seed), n)``, as numpy."""
    keys = determinism.split(determinism.master_key(seed), n)
    _, obs = vectorize(env, n).reset(keys)
    return obs.cpu().numpy()


def run(spec, requests: int = 400, rate: float = 2000.0, seed: int = 0,
        checkpoint: Optional[str] = None, warmup: int = 64,
        retry: int = 0, retry_backoff_ms: float = 2.0,
        device="cuda") -> dict:
    """Build ``spec``'s session on ``device``, serve it (loading
    ``checkpoint`` or the spec's newest capsule), drive ``requests``
    Poisson arrivals at ``rate`` req/s, and return::

        {"serve_qps": ..., "serve_p50_ms": ..., "serve_p99_ms": ...,
         "serve_mean_batch": ..., "serve_shed": ..., "serve_restarts": ...}
    """
    from repro_torch import api
    from repro_torch.serve.server import (DeadlineExceeded, DispatcherError,
                                          Overloaded, ServerClosed)
    session = api.build(spec, device=device)
    server = session.serve(checkpoint=checkpoint)
    rng = np.random.RandomState(seed)

    def _submit(ob, request_seed):
        if not retry:
            return server.submit(ob, seed=request_seed)
        for attempt in range(retry + 1):
            try:
                return server.submit(ob, seed=request_seed, block=False)
            except Overloaded:
                if attempt == retry:
                    raise
                # exponential backoff with seeded jitter in [0.5, 1.5)
                delay_ms = retry_backoff_ms * (2 ** attempt)
                time.sleep(delay_ms * (0.5 + rng.uniform()) / 1e3)

    try:
        # distinct observations, made before the clock starts
        n_obs = min(max(requests, 1), 512)
        obs = reset_obs(session.env, n_obs, seed)
        for i in range(min(warmup, requests)):      # steady-state warmup
            try:
                server.act(obs[i % n_obs], seed=1_000_000 + i)
            except (Overloaded, DeadlineExceeded, DispatcherError):
                pass    # a fault plan may hit warmup; it is not measured

        arrive = np.cumsum(rng.exponential(1.0 / rate, size=requests))
        done_at = np.zeros(requests)
        futures: list = [None] * requests
        shed = 0
        t0 = time.perf_counter()
        for i in range(requests):
            delay = (t0 + arrive[i]) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                fut = _submit(obs[i % n_obs], i)
            except Overloaded:
                shed += 1       # retries exhausted: this request is shed
                continue

            def _done(_fut, i=i):
                done_at[i] = time.perf_counter()
            fut.add_done_callback(_done)
            futures[i] = fut
        answered = np.zeros(requests, bool)
        for i, fut in enumerate(futures):
            if fut is None:
                continue
            try:
                fut.result(timeout=120)
                answered[i] = True
            except (Overloaded, DeadlineExceeded, DispatcherError,
                    ServerClosed):
                shed += 1       # typed shed: counted, never hung
        stats = server.stats()
    finally:
        server.stop()
    latency_ms = (done_at - (t0 + arrive)) * 1e3
    ans_lat = latency_ms[answered]
    n_ans = int(answered.sum())
    wall = max(float(done_at[answered].max() if n_ans else 0.0) - t0, 1e-9)
    p50, p99 = (np.percentile(ans_lat, [50, 99]) if n_ans
                else (float("nan"), float("nan")))
    return {
        "serve_qps": n_ans / wall,
        "serve_p50_ms": float(p50),
        "serve_p99_ms": float(p99),
        "serve_mean_batch": stats["mean_batch"],
        "serve_shed": shed,
        "serve_restarts": stats["n_restarts"],
    }
