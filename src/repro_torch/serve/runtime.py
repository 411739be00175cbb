"""The ``runtime="serve"`` engine entry.

Counterpart of ``repro/serve/runtime.py``. A serving runtime shares the
engine's construction contract (``factory(env, policy_apply, params,
opt, cfg, **kwargs)``, registry resolution, spec-driven builds through
``repro_torch.api``) but not its execution contract: it answers action
requests and runs no training intervals. ``run``/``state``/``run_from``
raise a TypeError pointing at ``Session.serve()``;
``engine.training_runtime_names`` leaves it out.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch import resolve_device
from repro_torch.core.engine import HTSConfig, register_runtime
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.server import PolicyServer, obs_template


@register_runtime("serve")
class ServeRuntime:
    name = "serve"

    def __init__(self, env, policy_apply: Callable, params, opt,
                 cfg: HTSConfig, serve: Optional[ServeConfig] = None,
                 faults=None, device=None):
        self.env = env
        self.policy_apply = policy_apply
        self.params = params
        self.opt = opt                # unused: serving never updates
        self.cfg = cfg
        self.serve_config = serve if serve is not None else ServeConfig()
        self.faults = faults          # the session's FaultInjector (or None)
        self.device = resolve_device(device)

    def init(self) -> None:
        pass

    # ------------------------------------------------ serving surface
    def server(self, params=None, start: bool = True) -> PolicyServer:
        """A PolicyServer (started unless ``start=False``) over
        ``params``, default the construction-time params; its padding
        rows are zero observations shaped as the env's reset."""
        srv = PolicyServer(
            self.policy_apply, self.params if params is None else params,
            obs_like=obs_template(self.env), serve=self.serve_config,
            seed=self.cfg.seed, faults=self.faults, device=self.device)
        return srv.start() if start else srv

    # ------------------------------------- training contract: refused
    def _no_training(self, what: str):
        from repro_torch.core import engine
        raise TypeError(
            f"the 'serve' runtime answers action requests, not training "
            f"intervals — {what} is not available; use Session.serve() "
            f"(or a training runtime: {engine.training_runtime_names()})")

    def run(self, n_intervals: int):
        self._no_training("run")

    def state(self):
        self._no_training("state")

    def run_from(self, state, n_intervals: int, finalize: bool = True):
        self._no_training("run_from")
