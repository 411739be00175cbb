"""TenantPool: many ExperimentSpecs time-sliced over one device, each
tenant's results bit-exact to its solo run.

Counterpart of ``repro/tenancy/pool.py``. A runtime's ``state()``
capsule at an interval boundary is a checkpoint, and ``run(n)`` equals
any partition into ``run_from`` segments bit for bit, so preemption is
free: suspend = capsule capture, resume = ``run_from``. Every tenant's
final params and episode-return streams equal its solo run's at any
weights, quanta and interleaving, across evict and readmit, and through
one tenant's injected faults.

Scheduling is stride fair-share over exact rationals: tenant i carries
a pass value p_i; a grant of ``q`` intervals charges ``q / weight_i``,
and the next grant goes to the runnable tenant with the smallest
``(p_i, admission index)``. The schedule is a pure function of
(admission order, weights, quanta, interval counts, lifecycle calls):
no clock anywhere, so it replays exactly.

Up to ``max_concurrency`` slices of DIFFERENT tenants run at once on a
``ThreadPoolExecutor`` (a tenant's own slices are serialized on its
capsule chain). Tenants share nothing (runtimes, buffers, key streams),
so overlap changes the wall clock only. On the card each tenant's
slices run on a CUDA stream of the tenant's own, so the streams each
runtime forks its two halves from and joins them into are never another
tenant's.

Fault domains are per tenant: each session carries its own
``FaultInjector``, and a failed slice is replayed from that tenant's
slice-boundary capsule (``run_from`` copies on restore, so the capsule
survives the failed attempt) with the tenant's own backoff and
``max_restarts``.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from fractions import Fraction
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import evaluate
from repro_torch.core.engine import TrainState
from repro_torch.core.tree import tree_leaves, tree_unflatten

ACTIVE, PAUSED, EVICTED, DONE = "active", "paused", "evicted", "done"


def capsule_params(state: TrainState, params_template):
    """The policy parameters inside a live capsule: the capsule's
    leading leaves in flatten order (the same prefix contract as
    ``checkpoint.io.restore_prefix``, applied in memory), shape-checked
    against the template loudly."""
    leaves = tree_leaves(state)
    tleaves = tree_leaves(params_template)
    if len(leaves) < len(tleaves):
        raise ValueError(
            f"capsule has {len(leaves)} leaves, params need "
            f"{len(tleaves)}")
    for i, (have, want) in enumerate(zip(leaves, tleaves)):
        if tuple(have.shape) != tuple(want.shape):
            raise ValueError(
                f"capsule leaf {i} shape {tuple(have.shape)} != params "
                f"leaf shape {tuple(want.shape)}")
    return tree_unflatten(params_template, leaves[:len(tleaves)])


@dataclass
class TenantResult:
    """One tenant's view of a pool run — the same reporting surface a
    solo ``Session.run`` + ``core.trainer.TrainReport`` would give."""
    name: str
    params: Any                  # final (reporting) params; None until done
    state: Optional[TrainState]  # mid-stream capsule at the last boundary
    intervals: int               # completed intervals
    target: int                  # the spec's interval budget
    steps: int
    wall_time: float             # device-occupancy: sum of slice walls
    sps: float
    rewards: np.ndarray          # (intervals, alpha, n_envs)
    dones: np.ndarray
    episode_returns: np.ndarray
    restarts: int
    status: str


class _Tenant:
    """Pool-internal per-tenant record: session + capsule chain +
    scheduler and reporting state, and on the card the CUDA stream the
    tenant's slices run on."""

    def __init__(self, name: str, session, weight: int, quantum: int,
                 index: int):
        self.name = name
        self.session = session
        self.weight = int(weight)
        self.quantum = int(quantum)
        self.index = index              # admission order (tie-break)
        self.status = ACTIVE
        self.passv = Fraction(0)        # stride pass value
        self.target = int(session.spec.intervals)
        self.granted = 0                # intervals granted (schedule side)
        self.done = 0                   # intervals completed (result side)
        self.state: TrainState = session.state()   # slice-boundary capsule
        self.returns = evaluate.ReturnStream(session.cfg.n_envs)
        self.rewards: List[np.ndarray] = []
        self.dones: List[np.ndarray] = []
        self.steps = 0
        self.wall = 0.0
        self.params = None              # final reporting params
        self.consec = 0                 # consecutive failed slices
        self.restarts = 0
        self.last_saved = 0             # intervals at last checkpoint
        device = session.runtime.device
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def on_stream(self):
        """The tenant's own CUDA stream as the current one (no-op on the
        CPU)."""
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    # ----------------------------------------------------------- result
    def result(self) -> TenantResult:
        cfg = self.session.cfg
        empty = np.zeros((0, cfg.alpha, cfg.n_envs), np.float32)
        return TenantResult(
            name=self.name,
            params=self.params,
            state=self.state,
            intervals=self.done,
            target=self.target,
            steps=self.steps,
            wall_time=self.wall,
            sps=self.steps / max(self.wall, 1e-9),
            rewards=(np.concatenate(self.rewards) if self.rewards
                     else empty),
            dones=np.concatenate(self.dones) if self.dones else empty,
            episode_returns=self.returns.returns,
            restarts=self.restarts,
            status=self.status,
        )


class TenantPool:
    """Admit N independent experiment specs into one device pool and
    time-slice between them at interval granularity.

        pool = Session.pool([spec_a, spec_b])        # or TenantPool(...)
        results = pool.run()                         # join on completion
        results["t0"].params                         # == solo run's, bit-exact

    * ``specs`` — ExperimentSpecs, spec dicts, or already-built
      Sessions. Each is admitted in order; per-tenant ``weight``/
      ``quantum``/``name`` come from the spec's ``tenancy`` block
      (overridable with the ``weights``/``names`` arguments, aligned by
      position — the CLI's ``--weight`` flags).
    * ``max_concurrency`` — how many slices may execute concurrently
      (different tenants only; 1 = strictly sequential). Results are
      bit-identical for every value — overlap is a wall-clock-only
      optimization.
    * ``on_slice`` — reporting callback ``(name, intervals_done,
      RunResult)`` after each slice commits, in grant order — the
      deterministic hook tests use to drive mid-run ``pause``/
      ``evict``/``readmit``.

    Lifecycle: ``admit`` (mid-run too), ``pause``/``resume``,
    ``evict``/``readmit`` — all take effect at slice boundaries (the
    only places a tenant's capsule exists). ``run`` drives the schedule
    until no tenant is runnable and returns ``{name: TenantResult}``
    for every tenant ever admitted (paused/evicted ones report their
    partial streams and ``status``).
    """

    def __init__(self, specs=(), weights=None, names=None,
                 max_concurrency: int = 2,
                 on_slice: Optional[Callable[[str, int, Any], None]] = None,
                 **build_overrides):
        if max_concurrency < 1:
            raise ValueError(
                f"max_concurrency must be >= 1, got {max_concurrency}")
        self.max_concurrency = int(max_concurrency)
        self.on_slice = on_slice
        self._build_overrides = build_overrides
        self._tenants: Dict[str, _Tenant] = {}
        self._order: List[str] = []     # admission order
        self.trace: List[Tuple[str, int, int]] = []  # (name, start, n)
        self._pending: deque = deque()  # (tenant, n, final, future)
        self._ex: Optional[ThreadPoolExecutor] = None
        specs = list(specs)
        weights = list(weights) if weights is not None else [None] * len(specs)
        names = list(names) if names is not None else [None] * len(specs)
        if len(weights) != len(specs) or len(names) != len(specs):
            raise ValueError(
                f"weights/names must align with specs: got {len(specs)} "
                f"spec(s), {len(weights)} weight(s), {len(names)} name(s)")
        for spec, w, nm in zip(specs, weights, names):
            self.admit(spec, weight=w, name=nm)

    # -------------------------------------------------------- admission
    def admit(self, spec, weight: Optional[int] = None,
              name: Optional[str] = None) -> str:
        """Admit one tenant (a spec, spec dict, or built Session).
        Returns the tenant name. New tenants start at the minimum
        active pass value, so a late arrival shares fairly from its
        admission onward instead of replaying the pool's history."""
        from repro_torch import api
        if isinstance(spec, api.Session):
            session = spec
        else:
            if isinstance(spec, dict):
                spec = api.from_dict(spec)
            session = api.build(spec, **self._build_overrides)
        ten = session.spec.tenancy
        name = name or ten.name or f"t{len(self._order)}"
        if name in self._tenants:
            raise ValueError(
                f"tenant name {name!r} already admitted; names must be "
                f"unique (set tenancy.name per spec)")
        t = _Tenant(name, session, weight or ten.weight, ten.quantum,
                    index=len(self._order))
        t.passv = self._min_active_pass()
        self._tenants[name] = t
        self._order.append(name)
        return name

    def _get(self, name: str) -> _Tenant:
        try:
            return self._tenants[name]
        except KeyError:
            raise KeyError(f"no tenant {name!r}; admitted: "
                           f"{self._order}") from None

    def _min_active_pass(self) -> Fraction:
        active = [t.passv for t in self._tenants.values()
                  if t.status == ACTIVE and t.granted < t.target]
        return min(active) if active else Fraction(0)

    # -------------------------------------------------------- lifecycle
    def pause(self, name: str) -> None:
        """Stop granting slices to a tenant (takes effect at the next
        grant decision; an in-flight slice still commits)."""
        t = self._get(name)
        if t.status not in (ACTIVE,):
            raise ValueError(f"cannot pause tenant {name!r} in status "
                             f"{t.status!r}")
        t.status = PAUSED

    def resume(self, name: str) -> None:
        """Resume a paused tenant. Its pass value is advanced to the
        current minimum active pass, so it resumes sharing from NOW
        rather than bursting to repay its paused time."""
        t = self._get(name)
        if t.status != PAUSED:
            raise ValueError(f"cannot resume tenant {name!r} in status "
                             f"{t.status!r}")
        t.status = ACTIVE
        t.passv = max(t.passv, self._min_active_pass())

    def evict(self, name: str) -> TenantResult:
        """Remove a tenant from scheduling and return its partial
        result. The capsule chain is retained: ``readmit`` continues it
        bit-exactly (preemption ≡ checkpoint round-trip, so evict +
        readmit is invisible to the tenant's final results)."""
        t = self._get(name)
        if t.status == DONE:
            raise ValueError(f"tenant {name!r} already completed")
        t.status = EVICTED
        return t.result()

    def readmit(self, name: str) -> None:
        """Re-admit an evicted tenant; it continues from its capsule."""
        t = self._get(name)
        if t.status != EVICTED:
            raise ValueError(f"cannot readmit tenant {name!r} in status "
                             f"{t.status!r}")
        t.status = ACTIVE
        t.passv = max(t.passv, self._min_active_pass())

    # -------------------------------------------------------- scheduler
    def _next(self) -> Optional[_Tenant]:
        """The stride decision: runnable tenant with the smallest
        (pass, admission index). Pure function of scheduler state."""
        best = None
        for name in self._order:
            t = self._tenants[name]
            if t.status != ACTIVE or t.granted >= t.target:
                continue
            if best is None or (t.passv, t.index) < (best.passv, best.index):
                best = t
        return best

    def _grant(self, t: _Tenant) -> Tuple[int, bool]:
        """Charge one grant to the tenant's pass and advance its
        schedule-side interval count."""
        n = min(t.quantum, t.target - t.granted)
        start = t.granted
        t.granted += n
        t.passv += Fraction(n, t.weight)
        self.trace.append((t.name, start, n))
        return n, t.granted >= t.target

    # -------------------------------------------------------- execution
    def _exec_slice(self, t: _Tenant, n: int, final: bool):
        """Run one slice (worker thread; per-tenant serialized). The
        tenant's own fault policy supervises: a failed attempt is
        replayed from the slice-boundary capsule — which survives the
        crash untouched, because run_from copies on restore — after the
        tenant's backoff. Injected events fire at most once, so the
        replay proceeds cleanly (repro_torch.faults)."""
        plan = t.session.spec.faults
        while True:
            try:
                t0 = time.perf_counter()
                with t.on_stream():
                    out = t.session.run_from(t.state, n, finalize=final)
                    state = t.session.state()
                t.consec = 0
                return out, state, time.perf_counter() - t0
            except Exception as e:
                if plan.max_restarts <= 0 or t.consec >= plan.max_restarts:
                    raise
                t.consec += 1
                t.restarts += 1
                delay = min(plan.backoff * (2 ** (t.consec - 1)),
                            plan.backoff_cap)
                print(f"[pool] tenant {t.name!r} slice at interval "
                      f"{t.done} failed ({type(e).__name__}: {e}); "
                      f"replay {t.consec}/{plan.max_restarts} after "
                      f"{delay:.3f}s backoff", flush=True)
                time.sleep(delay)

    def _commit(self) -> None:
        """Apply the oldest in-flight slice, in grant order (so
        ``on_slice`` ordering is deterministic)."""
        t, n, final, fut = self._pending.popleft()
        out, state, wall = fut.result()   # re-raises exhausted failures
        t.state = state
        t.done += n
        t.wall += wall
        t.steps += out.steps
        if out.rewards.size:
            t.rewards.append(out.rewards)
            t.dones.append(out.dones)
            t.returns.extend(out.rewards, out.dones)
        if final:
            t.params = out.params
            t.status = DONE
        self._maybe_checkpoint(t, final)
        if self.on_slice is not None:
            self.on_slice(t.name, t.done, out)

    def _wait_tenant(self, t: _Tenant) -> None:
        """Serialize a tenant's capsule chain: commit pending slices (in
        grant order) until this tenant has none in flight."""
        while any(p[0] is t for p in self._pending):
            self._commit()

    def _maybe_checkpoint(self, t: _Tenant, final: bool) -> None:
        """Per-tenant periodic checkpointing, riding the trainer's
        capsule format (core/trainer.py): a pool tenant's checkpoints
        are indistinguishable from a solo Trainer's, so the same
        ``--resume`` / ``Session.serve`` machinery consumes them."""
        ck = t.session.spec.checkpoint
        if not ck.dir:
            return
        due = ck.every and (t.done - t.last_saved) >= ck.every
        if not (due or (final and t.done > t.last_saved)):
            return
        import os
        from repro_torch.core import trainer as trainer_mod
        meta = trainer_mod.checkpoint_metadata(
            t.session.runtime, t.done, t.returns)
        trainer_mod.ckpt_io.save(
            os.path.join(ck.dir, f"step_{t.done:08d}"),
            trainer_mod.to_disk(t.state), metadata=meta)
        trainer_mod.prune_checkpoints(ck.dir, ck.keep)
        t.last_saved = t.done

    # -------------------------------------------------------------- run
    def step(self) -> bool:
        """Issue and commit ONE schedule grant synchronously. Returns
        False when no tenant is runnable. The unit tests' microscope;
        ``run`` is the production loop."""
        t = self._next()
        if t is None:
            return False
        n, final = self._grant(t)
        out, state, wall = self._exec_slice(t, n, final)
        from concurrent.futures import Future
        fut: Future = Future()
        fut.set_result((out, state, wall))
        self._pending.append((t, n, final, fut))
        self._commit()
        return True

    def run(self) -> Dict[str, TenantResult]:
        """Drive the schedule until no tenant is runnable (every active
        tenant reached its interval target); join and return every
        tenant's result. Grants are issued in deterministic stride
        order; execution overlaps up to ``max_concurrency`` slices of
        distinct tenants."""
        if self.max_concurrency == 1:
            while self.step():
                pass
            return self.results()
        ex = ThreadPoolExecutor(max_workers=self.max_concurrency,
                                thread_name_prefix="tenant-slice")
        try:
            while True:
                t = self._next()
                if t is None:
                    # a pending commit may finish a tenant or a
                    # lifecycle callback may readmit one — drain one
                    # commit and re-check before declaring completion
                    if self._pending:
                        self._commit()
                        continue
                    break
                # serialize this tenant's capsule chain, then respect
                # the in-flight bound (committing oldest-first)
                self._wait_tenant(t)
                while len(self._pending) >= self.max_concurrency:
                    self._commit()
                if t.status != ACTIVE or t.granted >= t.target:
                    continue    # a commit's callback changed its state
                n, final = self._grant(t)
                fut = ex.submit(self._exec_slice, t, n, final)
                self._pending.append((t, n, final, fut))
            return self.results()
        finally:
            ex.shutdown(wait=True)

    def results(self) -> Dict[str, TenantResult]:
        while self._pending:
            self._commit()
        return {name: self._tenants[name].result()
                for name in self._order}

    # ------------------------------------------------------------ serve
    def serve(self, serve=None, start: bool = True):
        """Multi-model serving over the pool: one ``PolicyServer``
        answering requests for EVERY tenant's policy, routed by model
        id (= tenant name) into per-model padding groups batched in one
        dispatcher loop (repro_torch.serve.server), on the first
        tenant's device. Each model keeps its own
        seed master (the tenant's ``hts.seed``), so every (model, obs,
        seed) request answers bit-identically to that tenant's
        single-model server regardless of cross-model batch
        composition .

        Parameters are each tenant's CURRENT capsule params (mid-pool
        serving serves what has been trained so far; a finished tenant
        serves its final params). ``serve`` overrides the admission/
        dispatch config (default: the first tenant's serve block)."""
        from repro_torch.serve.server import PolicyServer, obs_template
        if not self._order:
            raise ValueError("cannot serve an empty pool")
        first = self._tenants[self._order[0]]
        srv_cfg = serve if serve is not None else first.session.spec.serve
        server = None
        for name in self._order:
            t = self._tenants[name]
            s = t.session
            obs0 = obs_template(s.env)
            # a finished tenant serves its FINAL reporting params (the
            # trailing finalize pass is in t.params but not the capsule,
            # whose job is exact continuation); mid-stream tenants serve
            # the capsule at the last slice boundary
            if t.status == DONE and t.params is not None:
                params = t.params
            else:
                params = capsule_params(t.state, s.params)
            if server is None:
                server = PolicyServer(
                    s.policy.apply, params, obs_like=obs0,
                    serve=srv_cfg, seed=s.cfg.seed, model=name,
                    device=s.runtime.device)
            else:
                server.add_model(
                    name, s.policy.apply, params, obs_like=obs0,
                    max_batch=s.spec.serve.max_batch, seed=s.cfg.seed)
        return server.start() if start else server

    # ------------------------------------------------------------- misc
    def tenants(self) -> List[str]:
        return list(self._order)

    def status(self, name: str) -> str:
        return self._get(name).status

    def schedule_counts(self) -> Dict[str, int]:
        """Granted intervals per tenant — what fairness assertions and
        the Jain index (launch/pool.py) consume."""
        counts: Dict[str, int] = {name: 0 for name in self._order}
        for name, _start, n in self.trace:
            counts[name] += n
        return counts
