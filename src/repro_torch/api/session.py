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
per completed interval: live from the host runtime's coordinator, right
after the runtime returns for the fused runtimes (the same sequence
either way).

Live objects that cannot ride in a JSON spec (a ``torch.distributed``
process group for the sharded runtime, a custom ``HostConfig``) are
passed as ``build(spec, group=...)`` overrides; a spec's JSON
``host``/``acfg`` runtime kwargs become ``HostConfig`` /
``StepTimeModel`` / ``AsyncConfig`` here.

``Session.serve`` answers action requests for the session's policy
(``repro_torch.serve``), ``Session.pool`` admits several specs into one
``repro_torch.tenancy.TenantPool``.

Runtimes run on ``cuda`` unless ``build(spec, device="cpu")``; params
are drawn from ``policy.init(master_key(params_seed))``, on the CPU for
the small policies and on the device for the ``stream`` runtime's
``backbone``, whose runtime then keeps a host copy
(``core/stream_runtime.py``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from repro_torch import (algorithms, bridge, envs, models, optim,
                         resolve_device)
from repro_torch.api import spec as spec_mod
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import determinism, engine
from repro_torch.core.engine import HTSConfig, RunResult, TrainState
from repro_torch.envs.interfaces import Env

# what the reference builds and the port does not yet: name -> the
# ROADMAP queue 1 item that brings it
UNPORTED_RUNTIMES: Dict[str, str] = {}
UNPORTED_ENVS = {
    "football": "item 8 (football and the benchmarks)",
}

# the LLM learner's runtime: not in the engine registry (its workload is
# a TokenStream, not an Env; core/stream_runtime.py)
_STREAM_RUNTIME = "stream"


# runtimes that take spec.batch (the reference's "sharded" among them)
_BATCH_RUNTIMES = ("host", "mesh", "sharded")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP queue 1, {item}")


def runtime_names() -> list:
    """Every runtime name a spec may carry, ported or not."""
    return sorted(set(engine.runtime_names()) | set(UNPORTED_RUNTIMES)
                  | {_STREAM_RUNTIME})


def _decode_steptime(value, where: str):
    """JSON -> StepTimeModel for HostConfig duration fields; floats pass
    through (constant durations)."""
    if isinstance(value, dict):
        from repro_torch.envs.steptime import StepTimeModel
        unknown = set(value) - {"shape", "rate", "base"}
        if unknown:
            raise ValueError(
                f"unknown StepTimeModel field(s) {sorted(unknown)} in "
                f"{where}; known: ['shape', 'rate', 'base']")
        return StepTimeModel(**value)
    return value


def _decode_runtime_kwargs(name: str, kwargs: Dict[str, Any]) -> dict:
    """The JSON-able runtime kwargs a spec carries as the config objects
    the runtime constructors take (HostConfig / AsyncConfig /
    StepTimeModel)."""
    out = dict(kwargs)
    if name == "host":
        host = out.get("host")
        if isinstance(host, dict):
            from repro_torch.core.host_runtime import HostConfig
            host = dict(host)
            for key in ("step_time", "learner_time"):
                if key in host:
                    host[key] = _decode_steptime(host[key],
                                                 f"runtime.kwargs.host.{key}")
            try:
                out["host"] = HostConfig(**host)
            except TypeError as e:
                raise ValueError(f"bad host runtime kwargs: {e}") from None
    elif name == "async":
        acfg = out.get("acfg")
        if isinstance(acfg, dict):
            from repro_torch.core.baselines import AsyncConfig
            try:
                out["acfg"] = AsyncConfig(**acfg)
            except TypeError as e:
                raise ValueError(f"bad async runtime kwargs: {e}") from None
    return out


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
    if rt_name != _STREAM_RUNTIME:
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
    # workload/runtime pairing, validated before the policy is sized to
    # the env, so the error names the actual mismatch
    from repro_torch.data.pipeline import TokenStream
    if rt_name == _STREAM_RUNTIME:
        if not isinstance(env, TokenStream):
            raise ValueError(
                f"the 'stream' runtime consumes a TokenStream workload "
                f"(env 'token_stream'), got env {spec.env.name!r} -> "
                f"{type(env).__name__}")
    elif not isinstance(env, Env):
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
            f"{spec.env.name!r} -> {type(env).__name__} (the "
            f"'token_stream' source pairs only with runtime 'stream')")
    try:
        policy = models.get_policy(spec.policy.name, env,
                                   **spec.policy.kwargs)
    except TypeError as e:
        raise ValueError(
            f"bad policy kwargs for {spec.policy.name!r}: {e}") from None
    except AttributeError as e:
        raise ValueError(
            f"policy {spec.policy.name!r} could not be sized to env "
            f"{spec.env.name!r}: {e} (the token stream pairs with "
            f"config-backed policies like 'backbone')") from None
    try:
        opt = optim.get_optimizer(spec.optimizer.name,
                                  **spec.optimizer.kwargs)
    except TypeError as e:
        raise ValueError(
            f"bad optimizer kwargs for {spec.optimizer.name!r}: "
            f"{e}") from None
    cfg = spec.hts_config()
    # the small policies' params are drawn on the CPU; an LLM's on the
    # device it trains on
    params = policy.init(determinism.master_key(
        spec.params_seed,
        device=device if rt_name == _STREAM_RUNTIME else None))

    rkw = _decode_runtime_kwargs(rt_name, spec.runtime.kwargs)
    rkw.update(runtime_overrides)
    # the batch geometry threads into the runtimes that keep the
    # scale-out determinism contract; the baselines have no geometry to
    # factorize, so a non-default batch there is a spec error
    if rt_name in _BATCH_RUNTIMES + (_STREAM_RUNTIME,):
        rkw.setdefault("batch", spec.batch)
    elif not spec.batch.is_default:
        raise ValueError(
            f"runtime {rt_name!r} does not implement the batch-geometry "
            f"contract; non-default spec.batch pairs with "
            f"{sorted(_BATCH_RUNTIMES + ('stream',))}")

    # one injector spans the session: the host runtime's worker pools
    # and learner, and the trainer's checkpoint writes and supervision
    injector = None
    if spec.faults.events or spec.faults.max_restarts:
        from repro_torch.faults import FaultInjector
        injector = FaultInjector(spec.faults)
    if injector is not None and rt_name == "host":
        # the one training runtime with live fault sites (worker pools)
        rkw.setdefault("faults", injector)
    if rt_name in engine.SERVING_RUNTIMES:
        # the serving entry consumes the spec's serve block (dispatch
        # width, admission bound) and the dispatcher fault site
        rkw.setdefault("serve", spec.serve)
        if injector is not None:
            rkw.setdefault("faults", injector)

    if rt_name == _STREAM_RUNTIME:
        from repro_torch.core.stream_runtime import StreamRuntime
        if policy.config is None or not hasattr(policy.config,
                                                "vocab_size"):
            raise ValueError(
                f"the 'stream' runtime needs a config-backed policy "
                f"(e.g. 'backbone'), got {spec.policy.name!r}")
        if env.vocab != policy.config.vocab_size:
            raise ValueError(
                f"token stream vocab={env.vocab} != model "
                f"vocab_size={policy.config.vocab_size}; make "
                f"env.kwargs.vocab match the policy config")
        runtime = StreamRuntime(
            lambda: env_factory(**spec.env.kwargs), params, opt, cfg,
            model_config=policy.config, device=device, **rkw)
        # the session keeps the runtime's host copy: the device copy
        # drawn above is freed here
        params = runtime.params0
    else:
        if policy.apply is None:
            raise ValueError(
                f"policy {spec.policy.name!r} has no per-step apply "
                f"function; it pairs only with the 'stream' runtime")
        runtime = engine.make_runtime(rt_name, env, policy.apply, params,
                                      opt, cfg, device=device, **rkw)
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
        # a runtime with a live coordinator (host) calls the observers
        # as each interval completes; the others after they return
        live = self._observers and hasattr(self.runtime, "on_interval")
        if live:
            self.runtime.on_interval = self._emit
        try:
            out = fn()
        finally:
            if live:
                self.runtime.on_interval = None
        if self._observers and not live:
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

    # ------------------------------------------------------------ serve
    def serve(self, checkpoint: Optional[str] = None, start: bool = True):
        """A ``PolicyServer`` (started unless ``start=False``) answering
        action requests for this session's policy, configured by
        ``spec.serve``, on the session's device.

        Params come from a ``TrainState`` checkpoint: ``checkpoint``
        names one (the ``step_NNNNNNNN`` base path), else the newest
        complete one under ``spec.checkpoint.dir``; with neither, the
        session's initial params are served. Any runtime's capsule
        works: its leading leaves are the policy params
        (``checkpoint.io.restore_prefix``, in the reference's layout).
        ``runtime="serve"`` builds a session that can only serve."""
        from repro_torch.checkpoint import io as ckpt_io
        from repro_torch.serve.server import PolicyServer, obs_template
        if checkpoint is None and self.spec.checkpoint.dir:
            checkpoint = ckpt_io.latest(self.spec.checkpoint.dir)
        params = self.params
        if checkpoint is not None:
            params = bridge.policy_params_from_jax(ckpt_io.restore_prefix(
                checkpoint, bridge.policy_params_to_reference(self.params)))
        if hasattr(self.runtime, "server"):      # the serve runtime
            return self.runtime.server(params=params, start=start)
        server = PolicyServer(self.policy.apply, params,
                              obs_like=obs_template(self.env),
                              serve=self.spec.serve, seed=self.cfg.seed,
                              faults=self.faults,
                              device=self.runtime.device)
        return server.start() if start else server

    # ------------------------------------------------------------- pool
    @staticmethod
    def pool(specs, weights=None, names=None, max_concurrency: int = 2,
             on_slice=None, **build_overrides):
        """Admit several specs (or built Sessions) into one
        ``repro_torch.tenancy.TenantPool`` sharing this process's
        device:

            pool = Session.pool([spec_a, spec_b], weights=[2, 1])
            results = pool.run()          # {name: TenantResult}

        Weighted fair-share time-slicing at interval granularity; every
        tenant's final params and episode streams equal its solo ``run``
        bit for bit. ``build_overrides`` (``device="cpu"``, say) reach
        every tenant's ``build``."""
        from repro_torch.tenancy import TenantPool
        return TenantPool(specs, weights=weights, names=names,
                          max_concurrency=max_concurrency,
                          on_slice=on_slice, **build_overrides)

    # ------------------------------------------------------------ misc
    def describe(self) -> str:
        return spec_mod.dumps(self.spec, indent=2)
