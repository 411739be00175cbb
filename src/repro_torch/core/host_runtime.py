"""The paper's threaded HTS-RL runtime (Fig. 1(e) / Fig. 2(d)) on one host
and one device.

Counterpart of ``repro/core/host_runtime.py``, with its structure:

  * persistent worker pools per ``run`` segment: one executor thread per
    env replica, ``n_actors`` actor threads that batch whatever
    observations are ready, one stepper thread that steps the ready envs
    in one batched call over the stacked env states, one learner thread,
    and a simulated-learner thread when ``learner_time`` is set;
  * per-interval seed tables: all (step, env) action and transition keys
    of an interval in one call, so the executors never touch the PRNG;
  * ``SlabRing``: K+1 host slabs, interval j writes slab ``j % (K+1)``;
  * the split learner (delay-K, Eq. 6): the gradient over interval j's
    data is dispatched at theta_j the moment interval j ends and applied
    K intervals later, so it has K intervals of rollout to finish in.

What the GPU changes, and the choice made for each:

  * **The learner really overlaps the rollout.** A call in eager PyTorch
    blocks its caller for all of its Python-side launches, where JAX
    dispatches ``grad_fn`` asynchronously. So the gradient passes and
    the applies run on a learner thread with its own CUDA stream, in
    submission order. Each submission returns a handle: a future (the
    Python side) and a CUDA event recorded after its last launch. An
    apply runs on the same stream right after the gradient it consumes,
    so the stream orders the two and no cross-stream wait is needed.
    The reference's ``block_until_ready(self.dg)`` at the ring barrier
    is a host wait on the last apply's handle.
  * **The slab copy and the ring barrier.** On CUDA the slabs are
    page-locked and interval j's data goes to the device by a
    non-blocking copy enqueued on the learner's stream ahead of its
    gradient pass. The copy reads the slab after the call
    returns; the apply that consumes that gradient runs after the copy
    on the same stream, and the coordinator waits for that apply's event
    before it releases interval ``j + K + 1``, which rewrites the slab.
    So the ring barrier covers the copy, and no interval stalls on a
    synchronous copy. On the CPU the slab is handed over by reference.
  * **Thread-local torch state.** Grad mode, the current device and the
    current stream are per thread: every worker enters ``no_grad``, the
    runtime's device and a stream of its own. ``deterministic_cudnn``
    flips process-wide flags, so the coordinator enters it once around
    the whole segment.
  * **Bit-exactness against ``mesh``.** The reference packs the ready
    envs into rows in any order and relies on its vmapped programs being
    row-independent. Here a request keeps its env's own row of a fixed
    (n_envs, ...) batch: the actor forward runs on all rows and the
    requested ones are read; the env step runs on all rows and
    ``torch.where`` keeps the states of the rows not requested. A row's
    position is then its env id, as in ``mesh``, and a row's values
    depend on no other row's, whatever cuBLAS, cuDNN or the CPU's GEMM
    do with row order. The dispatch width is n_envs either way, as the
    reference's padding makes it, so no work is added.
  * **Host<->device round trips.** Each actor batch and each stepper
    batch ends in a copy to the host, which waits for the device.
  * **No donation.** Nothing here writes a tensor in place: the stepper
    rebinds the stacked env state to a new tensor, the apply builds a
    new ``DelayedGradState``. So a capsule, the caller's ``params0`` and
    an in-flight gradient never see a later write.

Stream safety: a tensor one thread's stream makes and another's reads is
complete before the reader starts (the coordinator's host waits: the
seed tables, the ring barrier) and stays referenced until the reader's
work has been waited for (every actor and stepper batch ends in a copy
to the host; the segment ends with a device synchronize).

The actor computation and the learner update are the functions the fused
runtime uses (``rollout.actor_forward``, ``mesh_runtime.make_grad_fn``,
``delayed_grad.update``, ``make_ring_drain``), so ``host`` and ``mesh``
give the same bits at every K. ``step_time``, ``time_scale``,
``actor_compute`` and ``learner_time`` change timing, never a value.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
import traceback
from collections import deque
from concurrent.futures import CancelledError, Future
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import delayed_grad, determinism
from repro_torch.core.batch import BatchConfig
from repro_torch.core.buffers import SlabRing, device_rollout_buffer
from repro_torch.core.engine import (HTSConfig, RunResult, TrainState,
                                     deterministic_cudnn, register_runtime,
                                     synchronize)
from repro_torch.core.mesh_runtime import (make_grad_fn, make_learner_update,
                                           make_ring_drain)
from repro_torch.core.rollout import actor_forward
from repro_torch.core.tree import tree_map
from repro_torch.envs.device import batched_env
from repro_torch.envs.steptime import StepTimeModel
from repro_torch.faults import FaultInjector, FaultPlan

_SHUTDOWN = object()          # queue sentinel for pool teardown


@dataclass
class HostConfig:
    n_actors: int = 4
    step_time: Optional[StepTimeModel] = None
    time_scale: float = 1.0          # multiply simulated durations
    actor_compute: float = 0.0       # optional simulated actor latency
    # simulated per-update learner duration: a float (constant) or a
    # StepTimeModel sampled per update index, deterministic like
    # step_time, so throughput experiments are replayable
    learner_time: "float | StepTimeModel" = 0.0
    profile: bool = False            # accumulate per-phase wall times


class _Handle:
    """A learner submission: ``future`` resolves when the learner thread
    has made its launches; ``event`` (CUDA only) is recorded on the
    learner's stream after them."""

    def __init__(self):
        self.future: Future = Future()
        self.event: Optional[torch.cuda.Event] = None

    def result(self):
        """The value, with the device work behind it finished."""
        out = self.future.result()
        if self.event is not None:
            self.event.synchronize()
        return out


def _keep_rows(mask, new, old):
    """``new`` where ``mask`` (n,) is set, ``old`` elsewhere, per leaf."""
    m = mask.reshape(mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


@register_runtime("host")
class HostHTSRL:
    name = "host"

    def __init__(self, env, policy_apply: Callable, params, opt,
                 cfg: HTSConfig, host: Optional[HostConfig] = None,
                 faults: "Optional[FaultInjector | FaultPlan]" = None,
                 batch=None, device=None, **host_kwargs):
        if host is not None and host_kwargs:
            # both forms at once would silently drop the kwargs:
            # HostHTSRL(..., host=HostConfig(), n_actors=8) would run
            # with 4 actors
            raise TypeError(
                f"pass either host=HostConfig(...) or HostConfig field "
                f"kwargs, not both (got host and {sorted(host_kwargs)})")
        if cfg.staleness < 1:
            raise ValueError(f"staleness must be >= 1, got {cfg.staleness}")
        self.device = resolve_device(device)
        self.env = env
        # the batched env the stepper calls (vmapped scalar env or the
        # device port), resolved here so a bad backend fails at once
        self.venv = batched_env(env, cfg.n_envs, cfg.env_backend)
        self.cfg = cfg
        self.host = host if host is not None else HostConfig(**host_kwargs)
        # one replica: a (grad_accumulation, n_replicas) factorization is
        # reproduced as chunks = A*R blocks inside the gradient pass,
        # the same bits as the default (the batch-geometry contract)
        self.batch = BatchConfig.of(batch)
        self.geometry = self.batch.resolve(cfg.n_envs, default_replicas=1)
        self.opt = opt
        self.policy_apply = policy_apply
        self.params0 = tree_map(lambda p: p.to(self.device), params)
        # deterministic chaos: worker loops and the coordinator poll this
        # injector at their (site, interval) points; an injected failure
        # takes the same path a real one does
        if faults is not None and not isinstance(faults, FaultInjector):
            faults = FaultInjector(FaultPlan.of(faults))
        self._faults = faults
        self._built = False
        self.dg = None    # built lazily: run() always starts via init()
        self.profile: Dict[str, float] = {}
        self._prof_lock = threading.Lock()
        self._threads: list = []
        self._zombies: list = []
        # reporting-only live observer, called by the coordinator as
        # ``on_interval(j, {"rewards": (alpha, n_envs), "dones": ...})``
        # when interval j's slab is complete (api.Session installs it)
        self.on_interval: Optional[Callable[[int, dict], None]] = None

    # ------------------------------------------------------------- build
    def _build(self) -> None:
        """Pieces made once and reused across init() resets."""
        if self._built:
            return
        cfg, dev = self.cfg, self.device
        self._cuda = dev.type == "cuda"
        master = determinism.master_key(cfg.seed, dev)
        ids = torch.arange(cfg.n_envs, dtype=torch.int64, device=dev)
        self._rows = ids
        # the action keys (env, g) and the transition keys (env +
        # 1_000_003, g) of every global step g of interval j, in one
        # call: (2, alpha, n_envs, 2)
        per_env = determinism.fold_in(
            master, torch.stack([ids, ids + 1_000_003]))[:, None]
        steps = torch.arange(cfg.alpha, dtype=torch.int64, device=dev)

        def make_tables(j: int):
            return determinism.fold_in(
                per_env, (j * cfg.alpha + steps)[None, :, None])

        self._tables_fn = make_tables
        self.grad_fn = make_grad_fn(self.policy_apply, cfg,
                                     grad_accumulation=self.geometry.chunks)
        # the reporting-only trailing drain of the K pending slots: the
        # fused runtime's own
        learn = make_learner_update(self.policy_apply, self.opt, cfg,
                                    grad_accumulation=self.geometry.chunks)
        self._final_fn = make_ring_drain(learn, cfg.staleness)
        obs_shape = self.env.obs_shape
        self._spec = {
            "obs": (obs_shape, np.float32 if obs_shape else np.int32),
            "actions": ((), np.int32),
            "rewards": ((), np.float32),
            "dones": ((), np.float32),
            "behavior_logprob": ((), np.float32),
        }
        self._slabs = SlabRing(cfg.alpha, cfg.n_envs, self._spec,
                               n_slots=cfg.staleness + 1, pin=self._cuda)
        if self._cuda:
            self._learner_stream = torch.cuda.Stream(dev)
            self._stepper_stream = torch.cuda.Stream(dev)
            self._actor_streams = [torch.cuda.Stream(dev)
                                   for _ in range(self.host.n_actors)]
        self._built = True

    def init(self) -> None:
        cfg, dev = self.cfg, self.device
        self._build()
        # params0 is copied: the caller's tensors never enter the run
        self.dg = delayed_grad.init(tree_map(torch.clone, self.params0),
                                    self.opt, staleness=cfg.staleness)
        keys = determinism.split(
            determinism.master_key(cfg.seed ^ 0x5EED, dev), cfg.n_envs)
        self.env_states, obs = self.venv.reset(keys)
        self.obs_np = obs.cpu().numpy().copy()     # writable host copy
        self.j = 0              # global interval counter
        # gradient passes in flight, oldest first, one per unconsumed
        # ring slot: {"j", "traj", "behavior", "handle", "ready"}
        self._pending: deque = deque()
        self._reset_logs()

    def _reset_logs(self) -> None:
        self.rewards_log: list = []
        self.dones_log: list = []
        self.sps_steps = 0
        self.wall_time = 0.0
        self.profile = {}

    def _prof(self, key: str, dt: float) -> None:
        with self._prof_lock:
            self.profile[key] = self.profile.get(key, 0.0) + dt

    # ------------------------------------------------------ continuation
    def _zero_traj(self):
        """An empty ring slot: the fused runtime's zero trajectory, so
        host and mesh capsules are one structure."""
        cfg = self.cfg
        obs_shape, obs_dtype = self._spec["obs"]
        return device_rollout_buffer(
            cfg.n_envs, cfg.alpha, obs_shape,
            torch.from_numpy(np.zeros((), obs_dtype)).dtype,
            device=self.device)

    def _buffer_ring(self):
        """The unconsumed read storage as the capsule/drain tree: slot p
        holds interval ``j - K + p``'s trajectory (zeros for intervals
        that never ran); one trajectory at K=1, K stacked slots else."""
        K = self.cfg.staleness
        have = {e["j"]: e["traj"] for e in self._pending}
        slots = [have.get(self.j - K + p) or self._zero_traj()
                 for p in range(K)]
        if K == 1:
            return dict(slots[0])
        return tree_map(lambda *xs: torch.stack(xs), *slots)

    def state(self) -> TrainState:
        """The continuation capsule, structurally the fused runtime's, so
        a host checkpoint restores into ``mesh`` and back. Every leaf is
        a copy (the slabs alias pending trajectories on the CPU)."""
        if self.dg is None:
            self.init()
        capsule = TrainState(
            self.dg, self.env_states,
            torch.from_numpy(self.obs_np).to(self.device),
            self._buffer_ring(), torch.tensor(self.j, dtype=torch.int32))
        out = tree_map(torch.clone, capsule)
        synchronize(self.device)
        return out

    def _restore(self, state: TrainState) -> None:
        def copy(tree):
            return tree_map(lambda x: x.to(self.device, copy=True), tree)

        self.dg = delayed_grad.DelayedGradState(*copy(tuple(state.algo)))
        self.env_states = copy(state.env_state)
        self.obs_np = np.array(state.obs.cpu())
        self.j = int(state.interval)
        K = self.cfg.staleness
        # the in-flight gradient passes the capsule implies: ring slot p
        # (the data of interval j-K+p) at its behavior params (history
        # slot p), re-dispatched when the segment's learner starts
        self._pending = deque()
        for p in range(K):
            i = self.j - K + p
            if i < 0:
                continue          # slot never filled (j < K)
            buf = dict(state.buffer)
            traj = copy(buf if K == 1 else tree_map(lambda x: x[p], buf))
            bp = (self.dg.params_prev if K == 1 else
                  tree_map(lambda h: h[p], self.dg.params_prev))
            self._pending.append({"j": i, "traj": traj, "behavior": bp,
                                  "handle": None, "ready": None})
        self._reset_logs()

    def run_from(self, state: TrainState, n_intervals: int,
                 finalize: bool = True) -> RunResult:
        self._build()
        self._restore(state)
        return self._segment(n_intervals, finalize)

    # ------------------------------------------------------------- pools
    def _worker(self, stream):
        """A worker thread's torch state: no autograd, the runtime's
        device and the thread's own stream (all per thread in torch)."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.no_grad())
        if self._cuda:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(stream))
            # a runtime call binds the device's primary context to this
            # thread before its first cuBLAS call (which warns without
            # one); the stream is empty, so this returns at once
            stream.synchronize()
        return stack

    def _spawn_pools(self) -> None:
        cfg = self.cfg
        # a worker that survived a previous segment's teardown (stuck in
        # a long call or sleep past the join timeout) must never deliver
        # a stale result into this segment's fresh queues: refuse
        zombies = [th for th in self._zombies if th.is_alive()]
        if zombies:
            raise RuntimeError(
                f"{len(zombies)} worker thread(s) from a previous segment "
                f"are still running after teardown; refusing to start a "
                f"new segment on this runtime")
        self._state_q: "queue.Queue" = queue.Queue()
        self._step_q: "queue.Queue" = queue.Queue()
        self._sim_q: "queue.Queue" = queue.Queue()
        self._learn_q: "queue.Queue" = queue.Queue()
        # the learner submissions not yet finished: the learner thread
        # discards each one as it resolves, so a finished gradient or
        # apply is held only by whoever waits on it
        self._handles: set = set()
        self._handles_lock = threading.Lock()
        self._action_slots = [queue.Queue() for _ in range(cfg.n_envs)]
        self._step_slots = [queue.Queue() for _ in range(cfg.n_envs)]
        self._start_barrier = threading.Barrier(cfg.n_envs + 1)
        self._end_barrier = threading.Barrier(cfg.n_envs + 1)
        self._pool_stop = False
        self._pool_exc: list = []

        def thread(fn, *args):
            return threading.Thread(target=self._guard, args=(fn, *args),
                                    daemon=True)

        self._threads = (
            [thread(self._actor_loop, i) for i in range(self.host.n_actors)]
            + [thread(self._stepper_loop), thread(self._learner_loop)]
            + [thread(self._executor_loop, e) for e in range(cfg.n_envs)])
        self._sim_learner_on = (
            isinstance(self.host.learner_time, StepTimeModel)
            or bool(self.host.learner_time))
        if self._sim_learner_on:
            self._threads.append(thread(self._sim_learner_loop))
        for th in self._threads:
            th.start()

    def _release_pool_waits(self) -> None:
        """Unblock every wait a pool thread or the coordinator can be
        parked on: both barriers, the request queues, the per-env slots,
        the learner's queue and its outstanding handles, the sim
        learner's gates. Idempotent; used by teardown and by ``_guard``
        when a worker dies."""
        self._pool_stop = True
        for barrier in (self._start_barrier, self._end_barrier):
            barrier.abort()
        for _ in range(self.host.n_actors):
            self._state_q.put(_SHUTDOWN)
        self._step_q.put(_SHUTDOWN)
        self._sim_q.put(_SHUTDOWN)
        self._learn_q.put(_SHUTDOWN)
        for slot in list(self._action_slots) + list(self._step_slots):
            slot.put(_SHUTDOWN)
        # a submission the learner never started would strand whoever
        # waits on it; one it is running completes
        with self._handles_lock:
            outstanding = list(self._handles)
        for h in outstanding:
            h.future.cancel()
        # the coordinator may wait on a pending gradient's ready gate:
        # if the sim learner died, nobody would set it
        for ent in list(self._pending):
            if ent.get("ready") is not None:
                ent["ready"].set()

    def _shutdown_pools(self) -> None:
        self._release_pool_waits()
        for th in self._threads:
            th.join(timeout=10.0)
        # stragglers are kept so that _spawn_pools refuses a new segment
        # while one is alive
        self._zombies = [th for th in self._threads if th.is_alive()]
        self._threads = []

    def _guard(self, fn, *args) -> None:
        """Worker wrapper: record the exception with its traceback for the
        coordinator to re-raise, and release every pool wait so nobody
        hangs. BaseException too: a KeyboardInterrupt or SystemExit in a
        worker must also fail the run, not kill the thread silently."""
        try:
            fn(*args)
        except BaseException as e:      # noqa: BLE001 — re-raised by _check_pool
            if self._pool_stop:
                return                  # normal teardown (aborted barrier)
            self._pool_exc.append((e, traceback.format_exc()))
            self._release_pool_waits()

    def _check_pool(self) -> None:
        if self._pool_exc:
            exc, tb = self._pool_exc[0]
            raise RuntimeError(
                f"host runtime worker thread died: {exc!r}\n"
                f"--- worker thread traceback ---\n{tb}") from exc

    def _drain_batch(self, q: "queue.Queue", first) -> Optional[list]:
        """The actor/stepper batching protocol: the blocking ``first``
        item, then up to ``n_envs`` ready requests taken greedily; a
        shutdown sentinel is put back for sibling workers. None on
        shutdown."""
        if first is _SHUTDOWN:
            return None
        batch = [first]
        while len(batch) < self.cfg.n_envs:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is _SHUTDOWN:
                q.put(_SHUTDOWN)      # keep the sentinel for siblings
                break
            batch.append(item)
        return batch

    # ----------------------------------------------------------- learner
    def _submit(self, fn, *args) -> _Handle:
        """Queue ``fn(*args)`` on the learner thread; the learner runs
        submissions one at a time in order, on its stream."""
        h = _Handle()
        with self._handles_lock:
            self._handles.add(h)
        self._learn_q.put((fn, args, h))
        return h

    def _resolved(self, h: _Handle) -> None:
        with self._handles_lock:
            self._handles.discard(h)

    def _learner_loop(self) -> None:
        prof = self.host.profile
        stream = self._learner_stream if self._cuda else None
        with self._worker(stream):
            while True:
                item = self._learn_q.get()
                if item is _SHUTDOWN:
                    return
                fn, args, h = item
                if not h.future.set_running_or_notify_cancel():
                    self._resolved(h)
                    continue
                t0 = time.perf_counter() if prof else 0.0
                try:
                    out = fn(*args)
                except BaseException as e:  # noqa: BLE001 — to its waiter
                    h.future.set_exception(e)
                    self._resolved(h)
                    if not isinstance(e, Exception):
                        raise               # and to _guard: the pool fails
                    continue
                if self._cuda:
                    h.event = torch.cuda.Event()
                    h.event.record(stream)
                if prof:
                    self._prof(f"learner_{fn.__name__.strip('_')}",
                               time.perf_counter() - t0)
                # out of the set before its waiter can see the result, so
                # an interval end never counts a finished submission
                self._resolved(h)
                h.future.set_result(out)

    def _grad(self, behavior, traj, poison: bool):
        grads = self.grad_fn(behavior, traj)
        if poison:
            grads = tree_map(lambda g: torch.full_like(g, float("nan")),
                             grads)
        return grads

    def _apply(self, dg, grad_handle: _Handle):
        # its gradient ran before it, on this stream
        return delayed_grad.update(dg, grad_handle.future.result(),
                                   self.opt)

    def _dispatch(self, ent: dict, poison: bool = False) -> None:
        ent["handle"] = self._submit(self._grad, ent["behavior"],
                                     ent["traj"], poison)
        if self._sim_learner_on:
            ent["ready"] = threading.Event()
            self._sim_q.put((ent["j"], ent["handle"], ent["ready"]))

    def _sim_learner_loop(self) -> None:
        """The simulated serial learner (``HostConfig.learner_time``):
        completes gradient passes in order, each taking its real compute
        time plus the simulated duration, so pass i's completion chains
        on pass i-1's like a single learner process. Durations come from a
        constant or a seeded StepTimeModel keyed on the data interval.
        Only the timing of the ready gate is simulated."""
        lt = self.host.learner_time
        while True:
            item = self._sim_q.get()
            if item is _SHUTDOWN:
                return
            data_j, handle, ready = item
            handle.result()
            dt = (lt.sample(0, data_j, self.cfg.seed ^ 0x1EA12)
                  if isinstance(lt, StepTimeModel) else lt)
            time.sleep(dt * self.host.time_scale)
            ready.set()

    # ------------------------------------------------------------ actors
    def _actor_fwd(self, params, obs, ts, table):
        """The actor forward on all n_envs rows (row = env id) with each
        row's key from the interval's table: (actions, behavior
        logprobs) on the host. ``obs`` and ``ts`` are host arrays."""
        obs = torch.from_numpy(obs).to(self.device)
        ts = torch.from_numpy(ts).to(self.device)
        actions, blp = actor_forward(self.policy_apply, params, obs,
                                     table[ts, self._rows])
        return actions.cpu().numpy(), blp.cpu().numpy()

    def _actor_loop(self, i: int) -> None:
        cfg, host = self.cfg, self.host
        n = cfg.n_envs
        q = self._state_q
        obs_shape, obs_dtype = self._spec["obs"]
        obs = np.zeros((n,) + tuple(obs_shape), obs_dtype)
        ts = np.zeros(n, np.int64)
        with self._worker(self._actor_streams[i] if self._cuda else None):
            while True:
                batch = self._drain_batch(q, q.get())
                if batch is None:
                    return
                if self._faults is not None:
                    self._faults.fire("actor", self._cur_j)
                for env_id, t, o in batch:
                    obs[env_id] = o
                    ts[env_id] = t
                if host.actor_compute:
                    time.sleep(host.actor_compute * host.time_scale)
                t0 = time.perf_counter() if host.profile else 0.0
                actions, blp = self._actor_fwd(self._behavior, obs, ts,
                                               self._actor_table)
                if host.profile:
                    self._prof("actor_forward", time.perf_counter() - t0)
                for env_id, _, _ in batch:
                    self._action_slots[env_id].put(
                        (int(actions[env_id]), float(blp[env_id])))

    # ----------------------------------------------------------- stepper
    def _step_batch(self, env_states, actions, mask, ts, table):
        """One env step on all n_envs rows; the rows not in ``mask`` keep
        their state. Returns (env_states', next obs, rewards, dones), the
        last three on the host."""
        dev = self.device
        actions = torch.from_numpy(actions).to(dev)
        mask = torch.from_numpy(mask).to(dev)
        ts = torch.from_numpy(ts).to(dev)
        ns, nobs, r, d = self.venv.step(env_states, actions,
                                        table[ts, self._rows])
        env_states = tree_map(lambda a, b: _keep_rows(mask, a, b), ns,
                              env_states)
        return (env_states, nobs.cpu().numpy(), r.cpu().numpy(),
                d.cpu().numpy())

    def _stepper_loop(self) -> None:
        """Steps the ready (env, step, action) requests together. Which
        envs land in which batch is racy and irrelevant: a row's
        transition depends only on its own (state, action, key)."""
        n = self.cfg.n_envs
        q = self._step_q
        prof = self.host.profile
        with self._worker(self._stepper_stream if self._cuda else None):
            while True:
                batch = self._drain_batch(q, q.get())
                if batch is None:
                    return
                if self._faults is not None:
                    self._faults.fire("stepper", self._cur_j)
                acts = np.zeros(n, np.int32)
                ts = np.zeros(n, np.int64)
                mask = np.zeros(n, np.bool_)
                for env_id, t, a in batch:
                    acts[env_id], ts[env_id], mask[env_id] = a, t, True
                if self._faults is not None:
                    # distinct from a stepper death: the ENV raising
                    # mid-step, at the env call
                    self._faults.fire("env_step", self._cur_j)
                t0 = time.perf_counter() if prof else 0.0
                self.env_states, nobs, r, d = self._step_batch(
                    self.env_states, acts, mask, ts, self._step_table)
                if prof:
                    self._prof("env_step_dispatch", time.perf_counter() - t0)
                for env_id, _, _ in batch:
                    self._step_slots[env_id].put(
                        (nobs[env_id], float(r[env_id]), float(d[env_id])))

    # --------------------------------------------------------- executors
    def _executor_loop(self, env_id: int) -> None:
        cfg, host = self.cfg, self.host
        prof = host.profile
        while True:
            try:
                self._start_barrier.wait()
            except threading.BrokenBarrierError:
                return                  # pool teardown
            if self._pool_stop:
                return
            j = self._cur_j
            if self._faults is not None:
                self._faults.fire("executor", j)
            slab, boot = self._cur_slab, self._cur_boot
            obs = self.obs_np[env_id]
            for t in range(cfg.alpha):
                self._state_q.put((env_id, t, obs))
                t0 = time.perf_counter() if prof else 0.0
                got = self._action_slots[env_id].get()
                if got is _SHUTDOWN:
                    return              # a sibling worker died mid-interval
                action, blp = got
                if prof:
                    self._prof("actor_wait", time.perf_counter() - t0)
                if host.step_time is not None:
                    dt = host.step_time.sample(env_id, j * cfg.alpha + t,
                                               cfg.seed)
                    time.sleep(dt * host.time_scale)
                    if prof:
                        self._prof("sim_env_sleep", dt * host.time_scale)
                self._step_q.put((env_id, t, action))
                t0 = time.perf_counter() if prof else 0.0
                got = self._step_slots[env_id].get()
                if got is _SHUTDOWN:
                    return
                nobs, r, d = got
                if prof:
                    self._prof("env_step_wait", time.perf_counter() - t0)
                slab["obs"][t, env_id] = obs
                slab["actions"][t, env_id] = action
                slab["rewards"][t, env_id] = r
                slab["dones"][t, env_id] = d
                slab["behavior_logprob"][t, env_id] = blp
                obs = nobs
            self.obs_np[env_id] = obs
            boot[env_id] = obs
            self._end_barrier.wait()

    # --------------------------------------------------------------- run
    def run(self, n_intervals: int) -> RunResult:
        self.init()   # engine contract: every run starts from params0
        return self._segment(n_intervals)

    def _run_intervals(self, n_intervals: int) -> None:
        cfg, host = self.cfg, self.host
        K = cfg.staleness
        prof = host.profile
        self._spawn_pools()
        try:
            # what the capsule had in flight, and init's tensors, before
            # any worker stream reads them
            synchronize(self.device)
            for ent in self._pending:
                self._dispatch(ent)
            dg_handle = None
            for j in range(self.j, self.j + n_intervals):
                self._check_pool()
                # ring-reuse barrier: the slab interval j rewrites was
                # last read (copied, on CUDA) for the gradient over
                # interval j-K-1's data, which the apply submitted at
                # interval j-1 consumed; waiting for that apply means
                # "read exhausted" before the roles rotate. With K > 1
                # that gradient was submitted K intervals ago, so a
                # learner slower than one interval no longer stalls
                # every interval.
                t0 = time.perf_counter() if prof else 0.0
                if dg_handle is not None:
                    self.dg = dg_handle.result()
                if prof:
                    self._prof("learner_drain", time.perf_counter() - t0)
                slab, boot = self._slabs.write_view(j)
                self._cur_j = j
                self._cur_slab, self._cur_boot = slab, boot
                self._behavior = self.dg.params     # theta_j
                self._actor_table, self._step_table = self._tables_fn(j)
                if self._cuda:     # the workers read them on their streams
                    torch.cuda.current_stream(self.device).synchronize()
                self._start_barrier.wait()          # release executors
                # the apply runs concurrently with rollout j: consume the
                # K-intervals-old pending gradient (delay-K, Eq. 6); the
                # first K intervals have nothing pending and skip (the
                # behavior history already holds theta_0)
                if len(self._pending) == K:
                    # peek, wait, then pop: the entry stays visible to
                    # _release_pool_waits while the coordinator waits on
                    # its gate, so a dying sim learner cannot strand it
                    ent = self._pending[0]
                    if ent["ready"] is not None:
                        t0 = time.perf_counter() if prof else 0.0
                        ent["ready"].wait()
                        if prof:
                            self._prof("sim_learner_wait",
                                       time.perf_counter() - t0)
                    self._pending.popleft()
                    dg_handle = self._submit(self._apply, self.dg,
                                             ent["handle"])
                t0 = time.perf_counter() if prof else 0.0
                self._end_barrier.wait()            # executors finished
                if prof:
                    self._prof("interval_barrier",
                               time.perf_counter() - t0)
                # interval done: the gradient over D_j at theta_j goes to
                # the learner now (the slab copy first, on CUDA, on the
                # learner's stream); it has K intervals of rollout before
                # its apply is waited for
                if self._cuda:
                    with torch.cuda.stream(self._learner_stream):
                        traj = self._slabs.as_traj(j, self.device)
                else:
                    traj = self._slabs.as_traj(j, self.device)
                poison = False
                if self._faults is not None:
                    # the "learner" site at interval j's gradient: exc
                    # raises here (the learner dies); nan makes the update
                    # all-NaN, poisoning params at the apply K intervals
                    # later, which the supervisor's finite check catches
                    # before any save (core/trainer.LearnerDiverged)
                    poison = self._faults.fire("learner", j) is not None
                ent = {"j": j, "traj": traj, "behavior": self._behavior,
                       "handle": None, "ready": None}
                self._dispatch(ent, poison)
                self._pending.append(ent)
                self.rewards_log.append(slab["rewards"].copy())
                self.dones_log.append(slab["dones"].copy())
                self.sps_steps += cfg.alpha * cfg.n_envs
                if self.on_interval is not None:
                    # the copies above decouple the observer from slab
                    # reuse; rollout j+1 proceeds while it runs
                    self.on_interval(j, {"rewards": self.rewards_log[-1],
                                         "dones": self.dones_log[-1]})
            if dg_handle is not None:
                self.dg = dg_handle.result()
            for ent in self._pending:
                ent["handle"].result()
            self.j += n_intervals
        except (threading.BrokenBarrierError, CancelledError):
            self._check_pool()
            raise
        finally:
            self._shutdown_pools()
        self._check_pool()

    def _segment(self, n_intervals: int, finalize: bool = True) -> RunResult:
        cfg = self.cfg
        t_start = time.perf_counter()
        with deterministic_cudnn():
            if n_intervals > 0:
                self._run_intervals(n_intervals)
            # the trailing drain of the K pending slots, reporting only:
            # self.dg stays mid-stream so state()/run_from continue
            # without applying these updates twice
            dg_final = self.dg
            if finalize:
                dg_final = self._final_fn(self.dg, self._buffer_ring(),
                                          self.j)
        synchronize(self.device)   # honest wall time / SPS
        self.wall_time = time.perf_counter() - t_start
        empty = np.zeros((0, cfg.alpha, cfg.n_envs), np.float32)
        return RunResult(
            params=dg_final.params, state=dg_final, steps=self.sps_steps,
            wall_time=self.wall_time,
            sps=self.sps_steps / max(self.wall_time, 1e-9),
            rewards=np.stack(self.rewards_log) if self.rewards_log else empty,
            dones=np.stack(self.dones_log) if self.dones_log else empty)
