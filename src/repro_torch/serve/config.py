"""ServeConfig: the serving-policy block of an ExperimentSpec.

Counterpart of ``repro/serve/config.py``, copied: a pure-Python
dataclass that ``api/spec.py`` validates and canonicalizes the
reference's way.

Validated eagerly at construction (like every other spec axis —
repro.api.spec): a bad ``max_batch`` fails when the spec is built, with
the field named, never as a shape error inside the dispatcher thread.

  * ``max_batch``  — the fixed dispatch width: every admitted batch is
    padded to exactly this many rows, so the serving loop compiles ONE
    program shape (the batched-stepper discipline of DESIGN.md §2.1,
    turned toward inference).
  * ``max_queue``  — admission-queue bound. A full queue rejects
    (``PolicyServer.submit(block=False)`` raises the typed
    ``Overloaded``) or backpressures (``block=True``) instead of
    growing without bound.
  * ``timeout_ms`` — how long the dispatcher waits for the FIRST
    request of a batch before re-checking for shutdown. It is NOT a
    batch-fill delay: once one request is admitted, whatever else is
    already queued (up to ``max_batch``) rides the same dispatch and
    the batch leaves immediately — continuous batching, no artificial
    latency in exchange for occupancy.

Graceful-degradation policy (DESIGN.md §11):

  * ``deadline_ms`` — per-request deadline, measured from ADMISSION to
    the moment the dispatcher picks the request up. A request that
    waited longer is failed with ``DeadlineExceeded`` instead of being
    served stale — under overload the queue sheds its oldest work
    instead of serving every request late. 0 (default) disables.
  * ``max_restarts`` — how many CONSECUTIVE dispatcher failures the
    server absorbs by restarting the dispatch loop in place (in-flight
    batch failed with ``DispatcherError``, queued requests untouched,
    health stays green). 0 (default): a dispatcher death poisons the
    server — the pre-existing fail-loud semantics.
  * ``restart_backoff_ms`` — sleep before restart #1; doubles each
    consecutive restart (capped at 1000 ms).
"""
from __future__ import annotations

from dataclasses import dataclass

_FIELDS = ("max_batch", "max_queue", "timeout_ms", "deadline_ms",
           "max_restarts", "restart_backoff_ms")


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 32
    max_queue: int = 1024
    timeout_ms: float = 20.0
    deadline_ms: float = 0.0
    max_restarts: int = 0
    restart_backoff_ms: float = 10.0

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(
                f"serve.max_batch must be >= 1, got {self.max_batch}")
        if self.max_queue < 1:
            raise ValueError(
                f"serve.max_queue must be >= 1, got {self.max_queue}")
        if self.timeout_ms <= 0:
            raise ValueError(
                f"serve.timeout_ms must be > 0, got {self.timeout_ms}")
        if self.deadline_ms < 0:
            raise ValueError(
                f"serve.deadline_ms must be >= 0 (0 disables), got "
                f"{self.deadline_ms}")
        if self.max_restarts < 0:
            raise ValueError(
                f"serve.max_restarts must be >= 0, got "
                f"{self.max_restarts}")
        if self.restart_backoff_ms < 0:
            raise ValueError(
                f"serve.restart_backoff_ms must be >= 0, got "
                f"{self.restart_backoff_ms}")

    def canonical(self) -> dict:
        return {"max_batch": int(self.max_batch),
                "max_queue": int(self.max_queue),
                "timeout_ms": float(self.timeout_ms),
                "deadline_ms": float(self.deadline_ms),
                "max_restarts": int(self.max_restarts),
                "restart_backoff_ms": float(self.restart_backoff_ms)}

    @staticmethod
    def of(value) -> "ServeConfig":
        if isinstance(value, ServeConfig):
            return value
        if value is None:
            return ServeConfig()
        if isinstance(value, dict):
            unknown = set(value) - set(_FIELDS)
            if unknown:
                raise ValueError(
                    f"unknown serve field(s) {sorted(unknown)}; known: "
                    f"{list(_FIELDS)}")
            return ServeConfig(**value)
        raise TypeError(f"serve must be a dict or ServeConfig, got "
                        f"{type(value).__name__}")
