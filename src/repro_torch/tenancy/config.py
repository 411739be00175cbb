"""TenancyConfig: the ``tenancy`` block of an ExperimentSpec.

Counterpart of ``repro/tenancy/config.py``, copied: a pure-Python
dataclass that ``api/spec.py`` validates and canonicalizes the
reference's way.

One spec = one *tenant* when admitted into a ``TenantPool``
(repro.tenancy.pool): this block carries everything the fair-share
scheduler needs to know about the spec — and nothing about the device
pool itself, which is a property of the pool, not of any one tenant.

  * ``weight``  — fair-share weight: over any long window of the
    schedule, an active tenant receives device intervals in proportion
    to its weight (stride scheduling; DESIGN.md §13). Weight changes
    WHEN a tenant's intervals run, never what they compute — a
    tenant's results are bit-exact to its solo run at any weight.
  * ``quantum`` — intervals per schedule grant: how many intervals the
    tenant runs each time it is picked before the pool preempts it at
    the next slice boundary (capsule capture). Larger quanta amortize
    per-slice dispatch overhead at the cost of coarser interleaving;
    the schedule charges a grant's full ``quantum/weight`` to the
    tenant's pass, so fairness is preserved for any mix of quanta.
  * ``name``    — optional stable tenant id (reports, the serving
    model id, eviction handles). Defaults to ``t<admission index>``
    at admission.

Validated eagerly at construction like every other spec block; popped
from ``workload_fingerprint`` (scheduling share changes wall-clock
interleaving, never what a training number means).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

_FIELDS = ("weight", "quantum", "name")


@dataclass(frozen=True)
class TenancyConfig:
    weight: int = 1
    quantum: int = 1
    name: Optional[str] = None

    def __post_init__(self):
        if int(self.weight) != self.weight or self.weight < 1:
            raise ValueError(
                f"tenancy.weight must be an integer >= 1, got "
                f"{self.weight!r}")
        if int(self.quantum) != self.quantum or self.quantum < 1:
            raise ValueError(
                f"tenancy.quantum must be an integer >= 1, got "
                f"{self.quantum!r}")
        if self.name is not None and (not isinstance(self.name, str)
                                      or not self.name):
            raise ValueError(
                f"tenancy.name must be a non-empty string (or null), "
                f"got {self.name!r}")

    @property
    def is_default(self) -> bool:
        return self == TenancyConfig()

    def canonical(self) -> dict:
        return {"weight": int(self.weight), "quantum": int(self.quantum),
                "name": self.name}

    @staticmethod
    def of(value) -> "TenancyConfig":
        if isinstance(value, TenancyConfig):
            return value
        if value is None:
            return TenancyConfig()
        if isinstance(value, dict):
            unknown = set(value) - set(_FIELDS)
            if unknown:
                raise ValueError(
                    f"unknown tenancy field(s) {sorted(unknown)}; "
                    f"known: {list(_FIELDS)}")
            return TenancyConfig(**value)
        raise TypeError(f"tenancy must be a dict or TenancyConfig, got "
                        f"{type(value).__name__}")
