"""Multi-tenant scheduling: many ExperimentSpecs sharing one device,
each bit-exact to its solo run.

Counterpart of ``repro/tenancy``:

  * ``TenancyConfig`` — the per-spec ``tenancy`` block (weight, quantum,
    name) the scheduler reads;
  * ``TenantPool``    — admission, stride fair-share over
    interval-boundary capsules, pause/resume/evict/readmit, per-tenant
    fault domains, multi-model serving;
  * ``TenantResult``  — one tenant's report (params, streams, sps).

Entry points: ``repro_torch.api.Session.pool([...])`` and
``python -m repro_torch.launch.pool --spec a.json --spec b.json``.
"""
from repro_torch.tenancy.config import TenancyConfig
from repro_torch.tenancy.pool import TenantPool, TenantResult, capsule_params

__all__ = ["TenancyConfig", "TenantPool", "TenantResult",
           "capsule_params"]
