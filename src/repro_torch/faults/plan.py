"""Deterministic fault injection: the chaos schedule and its injector.

Counterpart of ``repro/faults/plan.py``, copied: the module is pure
Python (``threading``, ``dataclasses``), and the port imports nothing of
``repro``. A ``FaultPlan`` is a declarative schedule of ``(site,
interval)`` events plus the recovery policy (``max_restarts``,
``backoff``, ``backoff_cap``); components poll the shared
``FaultInjector`` at those logical points. Every event fires at most
once, so a supervisor (``core/trainer.Trainer``) replaying interval j
after recovery does not re-trip the fault that killed it; the recovered
run then equals the fault-free run bit for bit.

Sites and kinds (each fires in the port where the reference fires it:
``checkpoint`` in ``core/trainer.Trainer``, the thread and dispatch sites
in the host runtime, ``core/host_runtime.py``, and ``dispatcher`` in
serving, ``serve/server.py``):

  =============  =======================  ===========================
  site           where it fires           kinds
  =============  =======================  ===========================
  actor          host actor thread        exc  (thread death)
  executor       host executor thread     exc  (thread death)
  stepper        host stepper thread      exc  (thread death)
  env_step       host env-step dispatch   exc  (env raises mid-step)
  learner        host learner dispatch    exc | nan (grads -> NaN)
  checkpoint     Trainer._save, after     truncate (corrupt the just-
                 the write completes       written npz in place)
  dispatcher     serve dispatch d         exc  (dispatcher death)
  =============  =======================  ===========================

``max_restarts=0`` (the default) disables supervision entirely.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

SITES = ("actor", "executor", "stepper", "env_step", "learner",
         "checkpoint", "dispatcher")

# kinds each site supports; first entry is the default
_SITE_KINDS = {
    "actor": ("exc",),
    "executor": ("exc",),
    "stepper": ("exc",),
    "env_step": ("exc",),
    "learner": ("exc", "nan"),
    "checkpoint": ("truncate",),
    "dispatcher": ("exc",),
}


class InjectedFault(RuntimeError):
    """The exception an ``exc``-kind event raises at its site. A
    RuntimeError subclass so it rides the same propagation paths a real
    component failure does (pool-guard re-raise, dispatcher failure) and
    the same supervisor catches both."""

    def __init__(self, event: "FaultEvent"):
        super().__init__(
            f"injected fault: site={event.site!r} "
            f"interval={event.interval} kind={event.kind!r}")
        self.event = event


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fire ``kind`` at ``(site, interval)``.

    ``interval`` is the site's logical clock: the global training
    interval j for the host/trainer sites, the checkpoint's cumulative
    interval count for ``checkpoint``, the dispatch index for
    ``dispatcher``.
    """
    site: str
    interval: int
    kind: str = ""          # "" -> the site's default kind

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; known sites: "
                f"{list(SITES)}")
        if self.interval < 0:
            raise ValueError(
                f"fault interval must be >= 0, got {self.interval} "
                f"(site {self.site!r})")
        kinds = _SITE_KINDS[self.site]
        if self.kind == "":
            object.__setattr__(self, "kind", kinds[0])
        elif self.kind not in kinds:
            raise ValueError(
                f"site {self.site!r} supports kind(s) {list(kinds)}, "
                f"got {self.kind!r}")

    def canonical(self) -> dict:
        return {"site": self.site, "interval": int(self.interval),
                "kind": self.kind}

    @staticmethod
    def of(value) -> "FaultEvent":
        if isinstance(value, FaultEvent):
            return value
        if isinstance(value, dict):
            unknown = set(value) - {"site", "interval", "kind"}
            if unknown:
                raise ValueError(
                    f"unknown fault event field(s) {sorted(unknown)}; "
                    f"an event is {{'site': ..., 'interval': ..., "
                    f"'kind': ...}}")
            missing = {"site", "interval"} - set(value)
            if missing:
                raise ValueError(
                    f"fault event needs {sorted(missing)} "
                    f"(got {sorted(value)})")
            return FaultEvent(value["site"], int(value["interval"]),
                              value.get("kind", ""))
        if isinstance(value, (tuple, list)) and 2 <= len(value) <= 3:
            return FaultEvent(*value)
        raise TypeError(
            f"a fault event is a dict, FaultEvent, or (site, interval"
            f"[, kind]) tuple, got {type(value).__name__}")


@dataclass(frozen=True)
class FaultPlan:
    """The spec-level chaos schedule + recovery policy (the ``faults``
    block of an ExperimentSpec). JSON-round-trippable like every other
    spec axis; validated eagerly at construction.

    * ``events``       — the fault schedule (each fires once, in listing
      order for duplicates).
    * ``seed``         — provenance marker for generated plans
      (``FaultPlan.generate``); inert for hand-written ones.
    * ``max_restarts`` — how many CONSECUTIVE failed segments the
      supervisor absorbs before re-raising (0 = no supervision:
      failures propagate exactly as before this layer existed).
    * ``backoff``      — seconds slept before restart #1; doubles each
      consecutive restart, capped at ``backoff_cap``.
    """
    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0
    max_restarts: int = 0
    backoff: float = 0.05
    backoff_cap: float = 2.0

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(FaultEvent.of(e) for e in self.events))
        if self.max_restarts < 0:
            raise ValueError(
                f"faults.max_restarts must be >= 0, got "
                f"{self.max_restarts}")
        if self.backoff < 0:
            raise ValueError(
                f"faults.backoff must be >= 0, got {self.backoff}")
        if self.backoff_cap < self.backoff:
            raise ValueError(
                f"faults.backoff_cap ({self.backoff_cap}) must be >= "
                f"faults.backoff ({self.backoff})")

    def canonical(self) -> dict:
        return {"events": [e.canonical() for e in self.events],
                "seed": int(self.seed),
                "max_restarts": int(self.max_restarts),
                "backoff": float(self.backoff),
                "backoff_cap": float(self.backoff_cap)}

    @staticmethod
    def of(value) -> "FaultPlan":
        if isinstance(value, FaultPlan):
            return value
        if value is None:
            return FaultPlan()
        if isinstance(value, dict):
            known = {"events", "seed", "max_restarts", "backoff",
                     "backoff_cap"}
            unknown = set(value) - known
            if unknown:
                raise ValueError(
                    f"unknown faults field(s) {sorted(unknown)}; "
                    f"known: {sorted(known)}")
            kw = dict(value)
            kw["events"] = tuple(FaultEvent.of(e)
                                 for e in kw.get("events", ()))
            return FaultPlan(**kw)
        raise TypeError(f"faults must be a dict or FaultPlan, got "
                        f"{type(value).__name__}")

    @staticmethod
    def generate(seed: int, n_intervals: int, n_events: int = 3,
                 sites: Sequence[str] = ("actor", "executor", "stepper",
                                         "env_step", "learner"),
                 max_restarts: int = 0, **kw) -> "FaultPlan":
        """A seeded random schedule: ``n_events`` faults at distinct
        intervals drawn from ``[1, n_intervals)``, sites round-robined
        through a seeded shuffle. Same seed -> same plan, so a CI chaos
        leg pins one number and replays the identical storm."""
        import numpy as np
        if n_intervals < 2:
            raise ValueError(
                f"generate needs n_intervals >= 2, got {n_intervals}")
        for s in sites:
            if s not in SITES:
                raise ValueError(f"unknown fault site {s!r}; known "
                                 f"sites: {list(SITES)}")
        rng = np.random.RandomState(seed)
        n_events = min(n_events, n_intervals - 1)
        ivals = np.sort(rng.choice(
            np.arange(1, n_intervals), size=n_events, replace=False))
        order = rng.permutation(len(sites))
        events = tuple(
            FaultEvent(sites[order[i % len(sites)]], int(j))
            for i, j in enumerate(ivals))
        restarts = max_restarts if max_restarts else n_events
        return FaultPlan(events=events, seed=seed,
                         max_restarts=restarts, **kw)


class FaultInjector:
    """The live, thread-safe side of a FaultPlan: components call
    ``fire(site, interval)`` (raise ``exc``-kind events, return others)
    or ``poll`` (never raises) at their logical injection points.

    Every event fires AT MOST ONCE per injector lifetime (the armed
    list shrinks), so a supervisor replaying interval j after recovery
    does not re-trip the fault that killed it — a transient fault, by
    construction. ``fired`` records what actually fired, in order, for
    reports and the recovery benchmark.

    One injector is shared across every surface of a Session (host
    runtime pools, Trainer checkpoint writes, the serve dispatcher), so
    a single plan spans training AND serving.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = FaultPlan.of(plan)
        self._armed: List[FaultEvent] = list(self.plan.events)
        self.fired: List[FaultEvent] = []
        self._lock = threading.Lock()

    def poll(self, site: str, interval: int) -> Optional[FaultEvent]:
        """Consume and return the first armed event at ``(site,
        interval)``, or None. Never raises."""
        with self._lock:
            for i, ev in enumerate(self._armed):
                if ev.site == site and ev.interval == int(interval):
                    del self._armed[i]
                    self.fired.append(ev)
                    return ev
        return None

    def fire(self, site: str, interval: int) -> Optional[FaultEvent]:
        """Like ``poll``, but ``exc``-kind events raise InjectedFault at
        the call site (the common case: simulate a component death
        exactly where a real one would surface). Non-exc kinds are
        returned for the caller to apply (NaN the grads, truncate the
        file)."""
        ev = self.poll(site, interval)
        if ev is not None and ev.kind == "exc":
            raise InjectedFault(ev)
        return ev

    @property
    def armed(self) -> Tuple[FaultEvent, ...]:
        with self._lock:
            return tuple(self._armed)
