"""``build(spec) -> Session``: resolve every ExperimentSpec axis through
the port's registries and wrap the constructed runtime in one surface.

Counterpart of ``repro/api/session.py``. ``build`` validates loudly:
unknown registry names raise ``KeyError`` listing what is registered, a
device-port env named as a workload or bad component kwargs raise
``ValueError``. A runtime, env or surface the reference has and the
port does not yet raises ``NotImplementedError`` naming the ROADMAP
queue 1 item that brings it; nothing runs in its place.

``Session`` wraps the engine contract (``run``/``state``/``run_from``)
and adds ``fit`` (checkpointed training through ``core/trainer.Trainer``
per the spec's CheckpointSpec) and ``on_interval`` observers, which
receive ``{"interval": j, "rewards": (alpha, n_envs), "dones": ...}``
per completed interval after the runtime returns (the ported runtime
has no live coordinator).

Runtimes run on ``cuda`` unless ``build(spec, device="cpu")``; params
are drawn on the CPU from ``policy.init(master_key(params_seed))``.
"""
from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch import algorithms, envs, models, optim, resolve_device
from repro_torch.api import spec as spec_mod
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import determinism, engine
from repro_torch.core.engine import HTSConfig, RunResult, TrainState
from repro_torch.envs.interfaces import Env

# what the reference builds and the port does not yet: name -> the
# ROADMAP queue 1 item that brings it
UNPORTED_RUNTIMES = {
    "host": "item 4 (the threaded host runtime)",
    "sync": "item 4 (the baselines)",
    "async": "item 4 (the baselines)",
    "sharded": "item 5 (the data-parallel runtime)",
    "serve": "item 6 (serving)",
    "stream": "item 7 (LLM-policy training)",
}
UNPORTED_ENVS = {
    "token": "item 7 (LLM-policy training)",
    "token_stream": "item 7 (LLM-policy training)",
    "football": "item 8 (football and the benchmarks)",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP queue 1, {item}")


def runtime_names() -> list:
    """Every runtime name a spec may carry, ported or not."""
    return sorted(set(engine.runtime_names()) | set(UNPORTED_RUNTIMES))


def build(spec: ExperimentSpec, device="cuda",
          **runtime_overrides) -> "Session":
    """Construct the experiment a spec describes, on ``device``.
    ``runtime_overrides`` are merged over the spec's runtime kwargs."""
    if not isinstance(spec, ExperimentSpec):
        raise TypeError(
            f"build takes an ExperimentSpec (got {type(spec).__name__}); "
            f"parse JSON with repro_torch.api.loads/load first")
    device = resolve_device(device)

    rt_name = spec.runtime.name
    if rt_name in UNPORTED_RUNTIMES:
        raise _not_ported(f"runtime {rt_name!r}", UNPORTED_RUNTIMES[rt_name])
    try:
        engine.get_runtime(rt_name)    # existence check
    except KeyError:
        raise KeyError(f"unknown runtime {rt_name!r}; "
                       f"registered: {runtime_names()}") from None
    algorithms.get_algorithm(spec.algorithm)
    if spec.env.name in UNPORTED_ENVS:
        raise _not_ported(f"env {spec.env.name!r}",
                          UNPORTED_ENVS[spec.env.name])
    env_factory = envs.get_env_factory(spec.env.name)
    try:
        env = env_factory(**spec.env.kwargs)
    except TypeError as e:
        raise ValueError(
            f"bad env kwargs for {spec.env.name!r}: {e}") from None
    if not isinstance(env, Env):
        from repro_torch.envs.device import DeviceEnv
        if isinstance(env, DeviceEnv):
            # "catch_device" etc. are selection outputs, not workloads:
            # the backend axis lives in the config
            raise ValueError(
                f"env {spec.env.name!r} is a device-resident port, not "
                f"a workload; name the host env "
                f"(env={env.host_name!r}) and select the port with "
                f"hts={{'env_backend': 'device'}}")
        raise ValueError(
            f"runtime {rt_name!r} consumes an Env workload, got env "
            f"{spec.env.name!r} -> {type(env).__name__}")
    try:
        policy = models.get_policy(spec.policy.name, env,
                                   **spec.policy.kwargs)
    except TypeError as e:
        raise ValueError(
            f"bad policy kwargs for {spec.policy.name!r}: {e}") from None
    try:
        opt = optim.get_optimizer(spec.optimizer.name,
                                  **spec.optimizer.kwargs)
    except TypeError as e:
        raise ValueError(
            f"bad optimizer kwargs for {spec.optimizer.name!r}: "
            f"{e}") from None
    cfg = spec.hts_config()
    params = policy.init(determinism.master_key(spec.params_seed))

    # every ported runtime takes the batch geometry (spec.batch)
    rkw = {"batch": spec.batch, **spec.runtime.kwargs, **runtime_overrides}

    # one injector for the session: the trainer's checkpoint site (the
    # only fault site the ported runtime has) and its supervision
    injector = None
    if spec.faults.events or spec.faults.max_restarts:
        from repro_torch.faults import FaultInjector
        injector = FaultInjector(spec.faults)

    runtime = engine.make_runtime(rt_name, env, policy.apply, params, opt,
                                  cfg, device=device, **rkw)
    return Session(spec, runtime, env, policy, params, opt, cfg,
                   faults=injector)


class Session:
    """One constructed experiment: the spec, its resolved pieces, and the
    engine-contract driving surface (plus observers and ``fit``)."""

    def __init__(self, spec: ExperimentSpec, runtime, env, policy,
                 params, opt, cfg: HTSConfig, faults=None):
        self.spec = spec
        self.runtime = runtime
        self.env = env
        self.policy = policy
        self.params = params      # initial parameters (policy.init)
        self.opt = opt
        self.cfg = cfg
        self.faults = faults      # the session-wide FaultInjector (or None)
        self._observers: List[Callable[[dict], None]] = []

    # ------------------------------------------------------- observers
    def on_interval(self, fn: Callable[[dict], None]):
        """Register a reporting-only per-interval metrics observer.
        Usable as a decorator; returns ``fn``."""
        self._observers.append(fn)
        return fn

    def remove_observer(self, fn) -> None:
        self._observers.remove(fn)

    def _emit(self, interval: int, metrics: dict) -> None:
        payload = {"interval": int(interval), **metrics}
        # a snapshot: an observer that removes itself must not shift its
        # successor out of this interval
        for fn in list(self._observers):
            fn(payload)

    def _run_observed(self, fn: Callable[[], RunResult],
                      start: int) -> RunResult:
        out = fn()
        for i, metrics in out.interval_metrics():
            self._emit(start + i, metrics)
        return out

    # -------------------------------------------------- engine contract
    def run(self, n_intervals: Optional[int] = None) -> RunResult:
        n = self.spec.intervals if n_intervals is None else n_intervals
        return self._run_observed(lambda: self.runtime.run(n), start=0)

    def state(self) -> TrainState:
        return self.runtime.state()

    def run_from(self, state: TrainState, n_intervals: int,
                 finalize: bool = True) -> RunResult:
        return self._run_observed(
            lambda: self.runtime.run_from(state, n_intervals, finalize),
            start=int(state.interval))

    # ------------------------------------------------------------- fit
    def fit(self, n_intervals: Optional[int] = None,
            resume: bool = False, on_segment=None):
        """Checkpointed training per the spec's CheckpointSpec
        (core/trainer.Trainer). Observers receive every interval's
        metrics, across segments and resumes."""
        from repro_torch.core.trainer import Trainer
        ck = self.spec.checkpoint
        trainer = Trainer(self.runtime, checkpoint_dir=ck.dir,
                          ckpt_every=ck.every, keep=ck.keep,
                          on_segment=on_segment,
                          on_interval=(self._emit if self._observers
                                       else None),
                          faults=self.faults)
        n = self.spec.intervals if n_intervals is None else n_intervals
        return trainer.fit(n, resume=resume)

    # ------------------------------------------------- not ported yet
    def serve(self, *args, **kwargs):
        """Policy-as-a-service: not ported yet."""
        raise _not_ported("Session.serve", UNPORTED_RUNTIMES["serve"])

    @staticmethod
    def pool(*args, **kwargs):
        """Multi-tenant pools: not ported yet."""
        raise _not_ported("Session.pool", "item 6 (tenancy)")

    # ------------------------------------------------------------ misc
    def describe(self) -> str:
        return spec_mod.dumps(self.spec, indent=2)
