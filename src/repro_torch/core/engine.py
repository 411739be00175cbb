"""The runtime engine: one protocol, a registry of schedulers.

Counterpart of ``repro/core/engine.py``:

  * ``HTSConfig``  — the shared hyperparameter bundle, every field of the
    reference's (``env_backend`` included);
  * ``Runtime``    — protocol: ``init()``, ``run(n) -> RunResult``,
    ``state()``, ``run_from(state, n)``. After ``run(n)`` exactly ``n``
    updates have been applied;
  * ``TrainState`` — the continuation capsule; ``run(a + b)`` is
    bit-identical to ``run(a)``, ``state()``, ``run_from(state, b)``;
  * the registry   — ``make_runtime(name, env, policy_apply, params, opt,
    cfg, device=None, **kwargs)``. Ported: ``mesh`` (the fused interval,
    ``core/mesh_runtime.py``). The host, sharded, sync, async and serve
    runtimes wait for later slices (ROADMAP queue 1).

Runtimes run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.tree import tree_map


class HTSConfig(NamedTuple):
    alpha: int = 16
    n_envs: int = 16
    gamma: float = 0.99
    value_coef: float = 0.5
    entropy_coef: float = 0.01
    algorithm: str = "a2c"          # any repro_torch.algorithms name
    use_gae: bool = False
    gae_lambda: float = 0.95
    ppo_clip: float = 0.2
    seed: int = 0
    # staleness bound K: slab-ring depth, delay-K update rule
    staleness: int = 1
    # "host" vmaps the scalar env (the bit-exactness oracle), "device"
    # steps its natively batched port (repro_torch.envs.device)
    env_backend: str = "host"


class TrainState(NamedTuple):
    """Everything a runtime needs to continue bit-exactly: ``algo`` (a
    ``DelayedGradState``), ``env_state`` and ``obs`` (n_envs, ...),
    ``buffer`` (the unconsumed ring: one trajectory at K=1, a leading K
    axis else) and ``interval`` (the global interval counter j, an int32
    tensor kept on the CPU: the host reads it for every interval's key
    offsets and skip, and a device copy would cost a sync each time).
    No PRNG state: keys are pure functions of (seed, env_id, step)."""
    algo: Any
    env_state: Any
    obs: Any
    buffer: Any
    interval: Any


@dataclass
class RunResult:
    """What ``run`` returns. ``rewards``/``dones`` are (n_intervals,
    alpha, n_envs) numpy arrays; ``state`` is the final
    ``DelayedGradState``; ``wall_time`` ends when the device has finished
    everything the run produced."""
    params: Any
    state: Any
    steps: int
    wall_time: float
    sps: float
    rewards: np.ndarray
    dones: np.ndarray
    metrics: Any = None

    def interval_metrics(self):
        """Yield ``(i, metrics)`` per interval: the reward/done slices
        plus any extra ``metrics`` streams, sliced on their leading
        interval axis (what ``api.Session`` and ``core/trainer.Trainer``
        hand their observers)."""
        extras = self.metrics or {}
        for i in range(self.rewards.shape[0]):
            m = {"rewards": self.rewards[i], "dones": self.dones[i]}
            for key, arr in extras.items():
                m[key] = arr[i]
            yield i, m


@runtime_checkable
class Runtime(Protocol):
    name: str

    def init(self) -> None:
        """(Re)build runtime state; resets to the initial state."""
        ...

    def run(self, n_intervals: int) -> RunResult:
        """``n_intervals`` intervals FROM THE INITIAL STATE."""
        ...

    def state(self) -> TrainState:
        """The continuation capsule (mid-stream: the last interval's
        trajectory still unconsumed in ``buffer``)."""
        ...

    def run_from(self, state: TrainState, n_intervals: int,
                 finalize: bool = True) -> RunResult:
        """Continue for ``n_intervals`` from ``state``; ``finalize=False``
        skips the reporting-only trailing passes."""
        ...


def _clone(tree):
    return tree_map(torch.clone, tree)


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN with deterministic algorithms and no autotuning (the CNN's
    weight gradients otherwise pick nondeterministic kernels), restored
    on exit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class ScanRuntimeBase:
    """Shared plumbing of the interval runtimes: build once, carry reset
    per ``run``, timing and RunResult assembly. Subclasses fill in

      _build()            closures built once (step, learner, drain)
      _initial_carry()    fresh training state
      _step(carry)        one interval: (carry', metrics)
      _result_state(c)    (params, state) out of the final carry
      _finalize(c)        reporting only: consume the unconsumed ring

    The carry is ``(algo, env_state, obs, buffer, j)``. ``state()`` and
    ``run_from`` copy what they hand over, as the reference does because
    JAX donates its carry: the port writes no carry tensor in place, and
    the copies keep it so should one ever do."""

    name: str = "?"

    def __init__(self, env, policy_apply: Callable, params, opt,
                 cfg: HTSConfig, device=None):
        self.device = resolve_device(device)
        self.env1 = env
        self.policy_apply = policy_apply
        self.params0 = tree_map(lambda p: p.to(self.device), params)
        self.opt = opt
        self.cfg = cfg
        self.carry = None
        self._built = False

    # ------------------------------------------------------------ hooks
    def _build(self) -> None:
        raise NotImplementedError

    def _initial_carry(self):
        raise NotImplementedError

    def _step(self, carry):
        raise NotImplementedError

    def _result_state(self, carry):
        raise NotImplementedError

    def _finalize(self, carry):
        return carry

    # --------------------------------------------------------- plumbing
    def init(self) -> None:
        if not self._built:
            self._build()
            self._built = True
        self.carry = self._initial_carry()

    def state(self) -> TrainState:
        if self.carry is None:
            self.init()
        return TrainState(*_clone(self.carry))

    def run(self, n_intervals: int) -> RunResult:
        self.init()
        return self._segment(n_intervals)

    def run_from(self, state: TrainState, n_intervals: int,
                 finalize: bool = True) -> RunResult:
        if not self._built:
            self._build()
            self._built = True
        algo, env_state, obs, buf, j = state
        on_device = tree_map(lambda x: x.to(self.device, copy=True),
                             (algo, env_state, obs, buf))
        # the interval counter stays on the host (TrainState)
        self.carry = (*on_device, torch.as_tensor(
            j, dtype=torch.int32).to("cpu", copy=True))
        return self._segment(n_intervals, finalize)

    def _segment(self, n_intervals: int, finalize: bool = True) -> RunResult:
        cfg = self.cfg
        synchronize(self.device)
        t0 = time.perf_counter()
        metrics = []
        with deterministic_cudnn():
            for _ in range(n_intervals):
                self.carry, m = self._step(self.carry)
                metrics.append(m)
            # self.carry stays mid-stream (continuable); the trailing
            # passes exist only so the RunResult reflects n updates
            final = self._finalize(self.carry) if finalize else self.carry
        params, state = self._result_state(final)
        empty = torch.zeros((0, cfg.alpha, cfg.n_envs), dtype=torch.float32)
        rewards = (torch.stack([m["rewards"] for m in metrics])
                   if metrics else empty)
        dones = (torch.stack([m["dones"] for m in metrics])
                 if metrics else empty)
        rewards, dones = rewards.cpu().numpy(), dones.cpu().numpy()
        synchronize(self.device)
        wall = time.perf_counter() - t0
        steps = n_intervals * cfg.alpha * cfg.n_envs
        return RunResult(
            params=params, state=state, steps=steps, wall_time=wall,
            sps=steps / max(wall, 1e-9), rewards=rewards, dones=dones)


# ---------------------------------------------------------------- registry
_REGISTRY: Dict[str, Callable[..., Runtime]] = {}

# name -> module that registers it (imported on first lookup)
_LAZY: Dict[str, str] = {
    "mesh": "repro_torch.core.mesh_runtime",
}


def register_runtime(name: str):
    """Class/factory decorator: ``@register_runtime("mesh")``."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def get_runtime(name: str) -> Callable[..., Runtime]:
    """Resolve a runtime factory by registry name."""
    if name not in _REGISTRY and name in _LAZY:
        importlib.import_module(_LAZY[name])
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown runtime {name!r}; "
                       f"registered: {runtime_names()}") from None


def runtime_names():
    return sorted(set(_REGISTRY) | set(_LAZY))


def training_runtime_names():
    """Registry names whose run/run_from execute training intervals (no
    serving runtime is ported yet, so all of them)."""
    return runtime_names()


def make_runtime(name: str, env, policy_apply, params, opt, cfg: HTSConfig,
                 **kwargs) -> Runtime:
    """``make_runtime("mesh", env1, policy.apply, params, opt, cfg)``;
    ``device="cpu"`` runs on the CPU, the default is ``cuda``."""
    return get_runtime(name)(env, policy_apply, params, opt, cfg, **kwargs)
