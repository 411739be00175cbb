"""PolicyServer: continuous-batching policy inference.

Counterpart of ``repro/serve/server.py``. Where the host runtime's
stepper gathers ready env requests into one fixed-shape dispatch, the
serving loop gathers ready action requests:

  submit() --> admission queue --> dispatcher thread
                                     gather <= max_batch ready requests
                                     pad to exactly max_batch rows
                                     request_key + actor_forward, once
                                       per model in the batch
                                     scatter actions to futures

Determinism contract: a request's sampling key is a pure function of
``(server seed, request seed)`` (``determinism.request_key``) and every
dispatch has the same shape, ``max_batch`` rows, so the SAME request
gets the SAME action and logprob, bit for bit, whatever the batch
composition, its row, the padding, the queue order or the arrival time.
The fixed shape is what makes that hold on the card: cuBLAS and cuDNN
choose kernels by shape, so a row's bits depend on the batch width, and
at one width they depend neither on the row's position nor on the other
rows (the H100 check in ``chip_smoke.py``'s ``phase_scale``). Padding
rows are zero observations whose answers are discarded.

The dispatcher is one thread running under ``torch.inference_mode``,
on a CUDA stream of its own when the server is on the card.

Multi-model serving (the pool half of ``repro_torch.tenancy``): one
server holds several policies behind one admission queue. ``add_model``
registers each under a model id with its own params, seed master and
padding width (warmed at registration); ``submit(..., model=...)``
routes. The dispatcher groups one gathered batch by model and makes one
call per model, so each (model, obs, seed) request answers as it would
from a single-model server of that model.

Failure discipline: a dispatcher death fails every pending and future
request with the original error instead of hanging clients. Shed
requests get typed errors, never a hung future:

  * ``Overloaded``        — admission queue full (``submit(block=False)``);
    a ``queue.Full``, so callers catching that still see it.
  * ``DeadlineExceeded``  — waited in the queue past
    ``ServeConfig.deadline_ms`` before the dispatcher picked it up.
  * ``DispatcherError``   — in flight when the dispatcher failed and was
    restarted in place (``ServeConfig.max_restarts``); queued requests
    survive the restart and the health probe stays green.
  * ``ServerClosed``      — submitted to a stopped, closing or dead
    server, or still queued when ``close()`` tore it down.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import determinism
from repro_torch.core.rollout import actor_forward
from repro_torch.core.tree import tree_map
from repro_torch.faults import FaultInjector, FaultPlan
from repro_torch.serve.config import ServeConfig

_SHUTDOWN = object()


class ServerClosed(RuntimeError):
    """Raised by submit/act on a stopped or dead server, and set on
    futures still queued when ``close()`` tears the server down."""


class Overloaded(queue.Full):
    """The admission queue is at ``max_queue``: the request is shed."""


class DeadlineExceeded(RuntimeError):
    """The request sat in the admission queue past its
    ``ServeConfig.deadline_ms``; shed instead of served stale."""


class DispatcherError(RuntimeError):
    """The request was in flight when the dispatcher failed; the server
    restarted in place, and only this batch was lost. Resubmitting is
    safe: serving is stateless and deterministic."""


@dataclass(frozen=True)
class ActionResult:
    """One answered request."""
    action: int
    logprob: float          # behavior logprob of the sampled action
    batch_size: int         # occupancy of the dispatch that served it


def obs_template(env) -> np.ndarray:
    """One observation of ``env`` (its reset under key 0) as numpy: the
    shape and dtype a server pads with."""
    _, obs = env.reset(determinism.master_key(0))
    return obs.detach().cpu().numpy()


@dataclass
class _Model:
    """One served policy: params on the server's device, seed master,
    padding width, its program and its counters (under the lock)."""
    name: str
    policy_apply: Callable
    params: object
    obs_shape: Tuple[int, ...]
    obs_dtype: object
    master: torch.Tensor
    max_batch: int
    program: Optional[Callable] = None
    n_requests: int = 0
    n_dispatches: int = 0
    n_rows: int = 0


@dataclass
class _Request:
    obs: np.ndarray
    seed: int
    future: Future
    model: Optional[_Model] = None
    admitted: float = 0.0      # monotonic admission time (deadline clock)


class PolicyServer:
    """Serve ``policy_apply(params, obs) -> (logits, value)`` through a
    continuous-batching loop on ``device`` (default ``cuda``).

    * ``obs_like`` — one observation (shape and dtype); submitted
      observations must match it.
    * ``seed``     — the server seed (the spec's ``hts.seed``):
      ``request_key(master_key(seed), request_seed)`` is the whole
      source of sampling randomness.

    Use as a context manager, or ``start()``/``stop()``. An unstarted
    server admits requests and lets them queue until ``start()``: how
    tests stage batch compositions.
    """

    def __init__(self, policy_apply: Callable, params, obs_like,
                 serve: Optional[ServeConfig] = None, seed: int = 0,
                 faults: "Optional[FaultInjector | FaultPlan]" = None,
                 model: str = "default", device=None):
        self.serve = serve if serve is not None else ServeConfig()
        self.device = resolve_device(device)
        self._seed = int(seed)
        self._models: dict = {}
        self._queue: "queue.Queue" = queue.Queue(self.serve.max_queue)
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self._closing = threading.Event()
        self._failure: Optional[BaseException] = None
        self._lock = threading.Lock()
        # "dispatcher"-site faults fire at dispatch index d
        if faults is not None and not isinstance(faults, FaultInjector):
            faults = FaultInjector(FaultPlan.of(faults))
        self._faults = faults
        self._dispatch_seq = 0    # dispatch attempts, failed ones included
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self.n_requests = 0
        self.n_dispatches = 0
        self.n_rows = 0           # sum of dispatch occupancies
        self.n_rejected = 0
        self.n_deadline = 0       # shed past deadline_ms
        self.n_restarts = 0       # in-place dispatcher restarts
        self._t0 = time.monotonic()   # QPS clock (reset at start())
        self._default = self._register(
            model, policy_apply, params, obs_like,
            self.serve.max_batch, seed)

    # ------------------------------------------------------------ build
    def _register(self, name: str, policy_apply: Callable, params,
                  obs_like, max_batch: int, seed: int) -> _Model:
        if name in self._models:
            raise ValueError(
                f"model {name!r} already served; model ids must be "
                f"unique (served: {sorted(self._models)})")
        if isinstance(obs_like, torch.Tensor):
            obs_like = obs_like.detach().cpu().numpy()
        obs_like = np.asarray(obs_like)
        m = _Model(name=name, policy_apply=policy_apply,
                   params=tree_map(lambda p: p.to(self.device), params),
                   obs_shape=tuple(obs_like.shape),
                   obs_dtype=obs_like.dtype,
                   master=determinism.master_key(seed, self.device),
                   max_batch=int(max_batch))
        m.program = self._compile(m)
        self._models[name] = m
        return m

    def _compile(self, m: _Model) -> Callable:
        """The model's dispatch: keys from the request seeds, then
        ``actor_forward`` over the padded batch. Run once here on zeros,
        so the first request does not pay the warm-up in its latency."""
        papply, master = m.policy_apply, m.master

        def prog(params, obs, seeds):
            keys = determinism.request_key(master, seeds)
            return actor_forward(papply, params, obs, keys)

        B = m.max_batch
        obs = torch.from_numpy(np.zeros((B,) + m.obs_shape, m.obs_dtype))
        with torch.inference_mode():
            actions, _ = prog(
                m.params, obs.to(self.device),
                torch.zeros((B,), dtype=torch.int64, device=self.device))
            actions.cpu()
        return prog

    def add_model(self, name: str, policy_apply: Callable, params,
                  obs_like, max_batch: Optional[int] = None,
                  seed: Optional[int] = None) -> "PolicyServer":
        """Register another policy under model id ``name`` with its own
        padding width (default the server's ``max_batch``) and seed
        master (default the server's seed): its answers equal a
        single-model server's of the same (policy, params, seed),
        whatever else shares the queue. Safe while the dispatcher runs:
        the model becomes routable when this returns."""
        self._register(
            name, policy_apply, params, obs_like,
            self.serve.max_batch if max_batch is None else max_batch,
            self._seed if seed is None else seed)
        return self

    def models(self) -> list:
        """Served model ids, default model first."""
        return [self._default.name] + sorted(
            n for n in self._models if n != self._default.name)

    # the default model's params and program, as a single-model server
    # exposes them (tests swap _program to inject dispatcher failures)
    @property
    def params(self):
        return self._default.params

    @params.setter
    def params(self, value) -> None:
        self._default.params = tree_map(lambda p: p.to(self.device), value)

    @property
    def policy_apply(self) -> Callable:
        return self._default.policy_apply

    @property
    def _program(self) -> Callable:
        return self._default.program

    @_program.setter
    def _program(self, value) -> None:
        self._default.program = value

    # -------------------------------------------------------- lifecycle
    def start(self) -> "PolicyServer":
        if self._thread is not None:
            raise ServerClosed("server already started")
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-dispatcher",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain: requests admitted before stop() are still answered."""
        if self._thread is None:
            return
        self._stopping.set()
        try:
            self._queue.put_nowait(_SHUTDOWN)
        except queue.Full:
            pass      # the loop notices _stopping at its next timeout tick
        self._thread.join()
        self._thread = None
        # fail anything that raced its way in behind the sentinel
        self._fail_pending(ServerClosed("server stopped"))

    def close(self) -> None:
        """Teardown biased toward shedding: stop admission now, let the
        in-flight dispatch finish (its futures resolve normally), fail
        everything still queued with ``ServerClosed``. Idempotent, and
        safe on a never-started or dead server."""
        self._closing.set()
        if self._thread is not None:
            try:
                self._queue.put_nowait(_SHUTDOWN)
            except queue.Full:
                pass  # the loop notices _closing at its next tick
            self._thread.join()
            self._thread = None
        self._fail_pending(ServerClosed("server closed"))

    def __enter__(self) -> "PolicyServer":
        return self.start() if self._thread is None else self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def dead(self) -> bool:
        return self._failure is not None

    @property
    def ready(self) -> bool:
        """Readiness probe: would a submit() right now be admitted?"""
        return (self._thread is not None and self._thread.is_alive()
                and not self.dead and not self._stopping.is_set()
                and not self._closing.is_set())

    def health(self) -> dict:
        """Liveness probe. ``ok`` stays True through in-place dispatcher
        restarts; it goes False when the server is dead (restarts spent)
        or torn down."""
        alive = self._thread is not None and self._thread.is_alive()
        with self._lock:
            restarts = self.n_restarts
        return {
            "ok": alive and not self.dead,
            "ready": self.ready,
            "dispatcher_alive": alive,
            "dead": self.dead,
            "queue_depth": self._queue.qsize(),
            "restarts": restarts,
        }

    # -------------------------------------------------------- admission
    def submit(self, obs, seed: int = 0, block: bool = True,
               model: Optional[str] = None) -> Future:
        """Admit one request; the Future resolves to an ActionResult.
        ``model`` routes to a served model id (default: the model the
        server was built with). ``block=False`` raises ``Overloaded``
        instead of waiting when the queue is at ``max_queue``."""
        if self._failure is not None:
            raise ServerClosed(
                f"serve dispatcher died: {self._failure!r}") \
                from self._failure
        if self._stopping.is_set() or self._closing.is_set():
            raise ServerClosed("server is stopping")
        if model is None:
            m = self._default
        else:
            m = self._models.get(model)
            if m is None:
                raise KeyError(
                    f"unknown model {model!r}; served models: "
                    f"{self.models()}")
        if isinstance(obs, torch.Tensor):
            obs = obs.detach().cpu().numpy()
        obs = np.asarray(obs, m.obs_dtype)
        if tuple(obs.shape) != m.obs_shape:
            raise ValueError(
                f"request obs shape {tuple(obs.shape)} != model "
                f"{m.name!r}'s obs shape {m.obs_shape}")
        req = _Request(obs=obs, seed=int(seed), future=Future(),
                       model=m, admitted=time.monotonic())
        try:
            self._queue.put(req, block=block)
        except queue.Full:
            with self._lock:
                self.n_rejected += 1
            raise Overloaded(
                f"admission queue is at max_queue="
                f"{self.serve.max_queue}; request shed") from None
        with self._lock:
            self.n_requests += 1
            m.n_requests += 1
        return req.future

    def act(self, obs, seed: int = 0, timeout: Optional[float] = None,
            model: Optional[str] = None) -> ActionResult:
        """Synchronous submit + wait."""
        return self.submit(obs, seed=seed,
                           model=model).result(timeout=timeout)

    # ------------------------------------------------------- dispatcher
    def _gather(self) -> Optional[list]:
        """Wait up to timeout_ms for the first request, then take what
        else is already queued, up to max_batch, without waiting for the
        batch to fill. Requests past their deadline are shed here, at
        pickup: only the dispatcher's clock knows how stale an answer
        would be."""
        try:
            first = self._queue.get(timeout=self.serve.timeout_ms / 1e3)
        except queue.Empty:
            return None
        if first is _SHUTDOWN:
            return []
        batch = [first]
        while len(batch) < self.serve.max_batch:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is _SHUTDOWN:
                self._stopping.set()
                break
            batch.append(req)
        if self.serve.deadline_ms:
            now = time.monotonic()
            live = []
            for req in batch:
                waited_ms = (now - req.admitted) * 1e3
                if waited_ms > self.serve.deadline_ms:
                    with self._lock:
                        self.n_deadline += 1
                    req.future.set_exception(DeadlineExceeded(
                        f"request waited {waited_ms:.1f}ms in queue, "
                        f"deadline is {self.serve.deadline_ms}ms"))
                else:
                    live.append(req)
            batch = live
        return batch

    def _dispatch(self, batch: list) -> None:
        """Group one gathered batch by model (first-appearance order) and
        run each group through its model's program at its model's width;
        a group wider than that is split."""
        groups: dict = {}
        for req in batch:
            groups.setdefault(req.model.name, []).append(req)
        for name, reqs in groups.items():
            m = self._models[name]
            for lo in range(0, len(reqs), m.max_batch):
                self._dispatch_model(m, reqs[lo:lo + m.max_batch])

    def _dispatch_model(self, m: _Model, batch: list) -> None:
        B = m.max_batch
        obs = np.zeros((B,) + m.obs_shape, m.obs_dtype)
        seeds = np.zeros((B,), np.int64)
        for i, req in enumerate(batch):
            obs[i] = req.obs
            seeds[i] = req.seed
        actions, logprobs = m.program(
            m.params, torch.from_numpy(obs).to(self.device),
            torch.from_numpy(seeds).to(self.device))
        actions = actions.cpu().numpy()
        logprobs = logprobs.cpu().numpy()
        with self._lock:
            self.n_dispatches += 1
            self.n_rows += len(batch)
            m.n_dispatches += 1
            m.n_rows += len(batch)
        for i, req in enumerate(batch):
            req.future.set_result(ActionResult(
                action=int(actions[i]), logprob=float(logprobs[i]),
                batch_size=len(batch)))

    def _loop(self) -> None:
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with torch.inference_mode(), stream:
            self._serve_loop()

    def _serve_loop(self) -> None:
        batch = None
        consec = 0          # consecutive failures (reset per dispatch)
        while True:
            try:
                while True:
                    batch = self._gather()
                    if batch is None:          # timeout tick
                        if self._stopping.is_set() or \
                                self._closing.is_set():
                            return
                        continue
                    if batch:
                        seq = self._dispatch_seq
                        self._dispatch_seq += 1   # counts failed attempts
                        if self._faults is not None:
                            self._faults.fire("dispatcher", seq)
                        self._dispatch(batch)
                        consec = 0
                    batch = None
                    if self._closing.is_set():
                        return      # close(): in-flight flushed, done
                    if self._stopping.is_set() and self._queue.empty():
                        return
            except Exception as e:     # noqa: BLE001 — reported to clients
                if consec < self.serve.max_restarts:
                    # degrade, don't die: only the in-flight batch is
                    # lost; queued requests stay admitted
                    consec += 1
                    with self._lock:
                        self.n_restarts += 1
                    err = DispatcherError(
                        f"dispatcher failed (in-place restart "
                        f"{consec}/{self.serve.max_restarts}): {e!r}")
                    err.__cause__ = e
                    for req in batch or ():
                        if not req.future.done():
                            req.future.set_exception(err)
                    batch = None
                    time.sleep(min(self.serve.restart_backoff_ms
                                   * 2 ** (consec - 1), 1000.0) / 1e3)
                    continue
                self._failure = e
                # the in-flight batch is already off the queue: fail its
                # futures here or its clients hang
                for req in batch or ():
                    if not req.future.done():
                        req.future.set_exception(e)
                self._fail_pending(e)
                return

    def _fail_pending(self, exc: BaseException) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is not _SHUTDOWN and not req.future.done():
                req.future.set_exception(exc)

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        with self._lock:
            return {
                "n_requests": self.n_requests,
                "n_dispatches": self.n_dispatches,
                "n_rejected": self.n_rejected,
                "n_deadline": self.n_deadline,
                "n_restarts": self.n_restarts,
                "mean_batch": (self.n_rows / self.n_dispatches
                               if self.n_dispatches else 0.0),
                "models": {
                    name: {
                        "n_requests": m.n_requests,
                        "n_dispatches": m.n_dispatches,
                        "mean_batch": (m.n_rows / m.n_dispatches
                                       if m.n_dispatches else 0.0),
                        "qps": m.n_requests / elapsed,
                    }
                    for name, m in sorted(self._models.items())
                },
            }
