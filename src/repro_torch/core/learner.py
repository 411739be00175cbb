"""LLM-policy learner pieces. Counterpart of ``repro/core/learner.py``;
only ``make_serve_step`` is ported so far (the LLM training step waits
for the LLM training slice, ROADMAP queue 1, item 14). The learner of the
small policies (mlp, cnn, token) is ported: ``core/mesh_runtime.py``
(``make_grad_fn``, ``make_learner_update``) on ``core/delayed_grad.py``
and ``repro_torch.algorithms``."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import backbone


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One-token decode; the actor's hot path."""

    def serve_step(model, token, cache, pos):
        return backbone.decode_step(model, cfg, token, cache, pos)

    return serve_step
