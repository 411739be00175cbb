"""The LLM-scale learner as an engine runtime: the ``TokenStream``
workload (``data/pipeline.py``) driven through the Runtime contract
(``core/engine.py``).

Counterpart of ``repro/core/stream_runtime.py``. One interval is one
delayed-gradient update over one (B, S) token batch
(``learner.make_train_step``). ``run(n)`` is a reset and replay;
``state()`` / ``run_from`` give the continuation capsule, so ``run(a +
b)`` equals ``run(a)`` then ``run_from(state, b)`` bit for bit (the
stream is a pure function of (seed, step): fast-forward is resume).
``RunResult.metrics`` streams the per-interval loss stats, and
``on_interval`` (set by ``api.Session``) receives them live.

Stream-batch numbering, as in the reference: batch 0 has always been the
launcher's shape probe, so interval j trains on batch j + 1.

Memory, for a model that fills the card: the step updates its state in
place (``delayed_grad.update_``), as the reference's jitted step donates
it, so the device holds one ``DelayedGradState`` (params, params_prev,
optimizer state) and the gradients. What the runtime hands out or takes
in stays off the device: ``params0`` and every ``state()`` capsule are
host copies (page-locked when the runtime runs on CUDA), and ``run_from``
frees the device state before it copies a capsule in.

``mesh``: ``"pod"`` and ``"multipod"`` build the production mesh over
the live process group (``launch/mesh.py``; it raises, naming the 256 or
512 ranks it needs, on any other world); ``"host"`` is a 1-D data mesh
over the group's world, or no mesh when no process group is up; a live
``DeviceMesh`` is taken as it is; None is no mesh. With a mesh, the
delayed-gradient state is placed by ``sharding.rules.dg_state_specs``
and each batch by ``batch_specs`` as ``DTensor``s, and the step runs
under ``use_mesh`` (``constrain``) and ``implicit_replication``; the
stats come back whole, and ``state()`` capsules hold whole tensors.
Without a mesh nothing of that runs: the same code and the same bits.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import delayed_grad, learner
from repro_torch.core.engine import HTSConfig, RunResult, TrainState
from repro_torch.core.tree import tree_map
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     use_mesh)
from repro_torch.optim import Optimizer
from repro_torch.sharding import rules

# algorithms whose loss the token-trajectory learner implements
# (stale-correction algorithms need behavior-lagged rollouts, which a
# TokenStream does not produce)
_ALGORITHMS = ("a2c", "ppo")


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s whole value on every rank; a tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory, page-locked when CUDA is up."""
    t = _whole(t)
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu",
                      pin_memory=torch.cuda.is_available())
    return out.copy_(t)


def _make_mesh(mesh, device: torch.device):
    """The runtime's ``DeviceMesh`` (or None) for its ``mesh`` argument."""
    if mesh is None or not isinstance(mesh, str):
        return mesh
    if mesh == "host":
        return make_host_mesh(device.type)
    return make_production_mesh(multi_pod=(mesh == "multipod"),
                                device_type=device.type)


def _distribute(tree, specs, mesh):
    """Each leaf of ``tree`` as a ``DTensor`` placed by its spec."""
    from torch.distributed.tensor import distribute_tensor
    return rules.map_specs(
        lambda t, s: distribute_tensor(t.detach(), mesh,
                                       rules.to_placements(s, mesh)),
        tree, specs)


class StreamRuntime:
    name = "stream"

    def __init__(self, stream_factory: Callable, params, opt: Optimizer,
                 cfg: HTSConfig, model_config, mesh="host",
                 n_microbatches: int = 1, batch=None, device=None):
        if cfg.algorithm not in _ALGORITHMS:
            raise ValueError(
                f"the stream runtime implements {list(_ALGORITHMS)}, got "
                f"algorithm {cfg.algorithm!r} (stale-correction "
                f"algorithms need behavior-lagged rollouts)")
        if cfg.staleness != 1:
            raise ValueError(
                f"the stream runtime is the delay-1 LLM learner; got "
                f"staleness={cfg.staleness}")
        if isinstance(mesh, str) and mesh not in ("host", "pod",
                                                  "multipod"):
            raise ValueError(f"unknown mesh name {mesh!r}; known: "
                             f"['host', 'pod', 'multipod']")
        self.device = resolve_device(device)
        self.stream_factory = stream_factory
        self.params0 = tree_map(_host_copy, params)
        self.opt = opt
        self.cfg = cfg
        self.model_config = model_config
        self.mesh = _make_mesh(mesh, self.device)
        self.batch = batch
        self.n_microbatches = n_microbatches
        self._step = None
        self.dg = None
        self.stream = None
        self.j = 0
        # reporting-only live observer (api.Session installs it): called
        # as ``on_interval(j, {"loss": ..., ...})`` per update
        self.on_interval: Optional[Callable[[int, dict], None]] = None

    # ------------------------------------------------------------ build
    def _build(self) -> None:
        if self._step is None:
            self._step = learner.make_train_step(
                self.model_config, self.opt, self.cfg.algorithm,
                self.n_microbatches, batch_geometry=self.batch)

    def _to_device(self, tree):
        return tree_map(lambda t: t.to(self.device, copy=True), tree)

    def _placed_state(self, dg):
        """``dg`` on the device; with a mesh, placed by the rules."""
        if self.mesh is None:
            return dg
        pspecs = rules.param_specs(dg.params, self.mesh)
        return _distribute(dg, rules.dg_state_specs(dg, pspecs, self.mesh),
                           self.mesh)

    def init(self) -> None:
        self._build()
        self.dg = None      # free the device state before making another
        self.dg = self._placed_state(
            delayed_grad.init(self._to_device(self.params0), self.opt))
        self.stream = self.stream_factory().skip(1)   # past the probe
        self.j = 0

    # ---------------------------------------------------- continuation
    def state(self) -> TrainState:
        if self.dg is None:
            self.init()
        return TrainState(
            algo=tree_map(_host_copy, self.dg),
            env_state={}, obs={}, buffer={},
            interval=torch.tensor(self.j, dtype=torch.int32))

    def run(self, n_intervals: int) -> RunResult:
        self.init()
        return self._segment(n_intervals)

    def run_from(self, state: TrainState, n_intervals: int,
                 finalize: bool = True) -> RunResult:
        del finalize   # updates are consumed inline; nothing trails
        self._build()
        self.dg = None
        self.dg = self._placed_state(delayed_grad.DelayedGradState(
            *self._to_device(tuple(state.algo))))
        self.j = int(state.interval)
        self.stream = self.stream_factory().skip(1 + self.j)
        return self._segment(n_intervals)

    # -------------------------------------------- checkpoint layout
    def to_reference(self, state: TrainState) -> TrainState:
        """A capsule in the reference's layout (tensor leaves): what a
        checkpoint holds."""
        from repro_torch import bridge
        return state._replace(algo=bridge.backbone_state_to_reference(
            state.algo, self.model_config))

    def from_reference(self, tree) -> TrainState:
        from repro_torch import bridge
        algo, env_state, obs, buffer, interval = tree
        return TrainState(
            algo=bridge.backbone_state_from_jax(algo, self.model_config),
            env_state={}, obs={}, buffer={},
            interval=torch.as_tensor(np.asarray(interval), dtype=torch.int32))

    def _mesh_step(self, batch: dict):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        batch = _distribute(batch, rules.batch_specs(batch, self.mesh),
                            self.mesh)
        with use_mesh(self.mesh), implicit_replication():
            dg, stats = self._step(self.dg, batch)
            stats = {k: _whole(v) for k, v in stats.items()}
        return dg, stats

    # -------------------------------------------------------- the loop
    def _segment(self, n_intervals: int) -> RunResult:
        t0 = time.perf_counter()
        stats_log = []
        for j in range(self.j, self.j + n_intervals):
            batch = {k: v.to(self.device)
                     for k, v in self.stream.next_batch().items()}
            if self.mesh is None:
                self.dg, stats = self._step(self.dg, batch)
            else:
                self.dg, stats = self._mesh_step(batch)
            stats_log.append(stats)
            if self.on_interval is not None:
                self.on_interval(j, {k: float(v) for k, v in stats.items()})
        self.j += n_intervals
        metrics = {}
        if stats_log:
            metrics = {k: np.asarray([float(s[k]) for s in stats_log],
                                     np.float32)
                       for k in stats_log[0]}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        steps = n_intervals * self.stream.batch * self.stream.seq
        empty = np.zeros((n_intervals, 0, 0), np.float32)
        return RunResult(
            params=self.dg.params, state=self.dg, steps=steps,
            wall_time=wall, sps=steps / max(wall, 1e-9),
            rewards=empty, dones=empty, metrics=metrics or None)
