"""Policy-as-a-service: serve trained policies through the batched,
fixed-shape dispatch that makes training fast.

Counterpart of ``repro/serve``:

  * ``ServeConfig``   — the spec's ``serve`` block, validated eagerly;
  * ``PolicyServer``  — admission queue and one dispatcher thread that
    gathers ready requests into a padded fixed-shape ``actor_forward``,
    with per-request deterministic seeding;
  * ``ServeRuntime``  — the ``runtime="serve"`` registry entry
    (``repro_torch.api.build(spec).serve()`` is the usual path);
  * ``loadgen``       — the open-loop Poisson load generator.
"""
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.server import (ActionResult, DeadlineExceeded,
                                      DispatcherError, Overloaded,
                                      PolicyServer, ServerClosed)

__all__ = ["ActionResult", "DeadlineExceeded", "DispatcherError",
           "Overloaded", "PolicyServer", "ServeConfig", "ServerClosed"]
