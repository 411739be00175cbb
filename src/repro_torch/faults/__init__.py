"""Deterministic fault injection and its schedule (counterpart of
``repro/faults``): ``FaultPlan`` declares a seeded chaos schedule,
``FaultInjector`` fires it at logical ``(site, interval)`` points, and
the supervisor (``core/trainer.Trainer``) recovers bit-exactly from what
it breaks."""
from repro_torch.faults.plan import (SITES, FaultEvent, FaultInjector,
                                     FaultPlan, InjectedFault)

__all__ = ["SITES", "FaultEvent", "FaultInjector", "FaultPlan",
           "InjectedFault"]
