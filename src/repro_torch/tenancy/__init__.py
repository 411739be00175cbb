"""Multi-tenant scheduling: only the spec's ``tenancy`` block
(``TenancyConfig``) is ported; ``TenantPool`` waits for ROADMAP queue 1,
item 6."""
from repro_torch.tenancy.config import TenancyConfig  # noqa: F401
