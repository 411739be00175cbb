"""Policy-as-a-service: only the spec's ``serve`` block
(``ServeConfig``) is ported; the server, its runtime and load generator
wait for ROADMAP queue 1, item 6."""
from repro_torch.serve.config import ServeConfig  # noqa: F401
