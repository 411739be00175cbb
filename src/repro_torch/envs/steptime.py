"""Environment step-time models (a copy of ``repro/envs/steptime.py``:
numpy and ``time`` only).

The paper's Claims 1–2 and the throughput experiments depend on the *step
time distribution*, not on game content. ``StepTimeModel`` provides
deterministic per-(env, step) simulated durations for the virtual-clock
harness (container-core-count independent) and can also busy-wait or
sleep for real wall-clock experiments in the threaded host runtime.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StepTimeModel:
    """Step time ~ Gamma(shape, rate). shape=1 -> exponential (the paper's
    Fig. 3 setting); variance = shape / rate^2."""
    shape: float = 1.0
    rate: float = 2.0
    base: float = 0.0          # deterministic floor added to every step

    def sample(self, env_id: int, step: int, seed: int = 0) -> float:
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, env_id, step]))
        return float(self.base + rng.gamma(self.shape, 1.0 / self.rate))

    def sample_batch(self, n_envs: int, n_steps: int, seed: int = 0):
        rng = np.random.default_rng(np.random.SeedSequence([seed]))
        return self.base + rng.gamma(self.shape, 1.0 / self.rate,
                                     size=(n_steps, n_envs))

    @property
    def mean(self) -> float:
        return self.base + self.shape / self.rate

    @property
    def variance(self) -> float:
        return self.shape / self.rate ** 2


def busy_wait(seconds: float) -> None:
    """Spin (not sleep) — models a CPU-bound game engine step."""
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


CONSTANT = StepTimeModel(shape=1e6, rate=1e6 / 1.0)   # ~constant 1.0
LOW_VAR = StepTimeModel(shape=16.0, rate=16.0)        # mean 1, var 1/16
EXP_VAR = StepTimeModel(shape=1.0, rate=1.0)          # mean 1, var 1
HIGH_VAR = StepTimeModel(shape=0.25, rate=0.25)       # mean 1, var 4
