"""Checkpointed continuation driver: periodic checkpoints, resume from
the latest, streaming evaluation, and fault supervision over a runtime.

Counterpart of ``repro/core/trainer.py``:

    rt = engine.make_runtime("mesh", env, papply, params, opt, cfg)
    trainer = Trainer(rt, checkpoint_dir="ckpts", ckpt_every=50)
    report = trainer.fit(10_000, resume=True)   # picks up where it died

``fit`` drives the runtime only through ``run_from``, in
``ckpt_every``-interval segments, capturing the ``TrainState`` capsule
after each and writing it through ``checkpoint.io`` with versioned
metadata (format, runtime, algorithm, seed, geometry, interval count and
the ``ReturnStream`` carry). Since ``run(a + b)`` equals any partition
into ``run_from`` segments bit for bit, a run stopped after a checkpoint
and resumed by a fresh process ends with the uninterrupted run's
parameters. The files are the reference's: the capsule goes to disk in
the reference's layout (``bridge.train_state_to_reference``, conv
kernels HWIO) and comes back through ``bridge.train_state_from_jax``, so
either package resumes the other's run.
"""
from __future__ import annotations

import glob
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.core import evaluate
from repro_torch.core.engine import Runtime, TrainState
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.faults import FaultInjector, FaultPlan

CKPT_FORMAT = "hts-trainstate-v1"


def checkpoint_metadata(runtime: Runtime, intervals: int,
                        stream: evaluate.ReturnStream) -> dict:
    """The versioned manifest metadata written beside every capsule, the
    reference's keys and values (``runtime`` is the registry name,
    ``mesh`` in both packages)."""
    cfg = runtime.cfg
    meta = {
        "format": CKPT_FORMAT,
        "runtime": runtime.name,
        "algorithm": cfg.algorithm,
        "seed": cfg.seed,
        "alpha": cfg.alpha,
        "n_envs": cfg.n_envs,
        "staleness": cfg.staleness,
        "intervals": intervals,
        "metrics": stream.state_dict(),
    }
    # batch geometry rides in the manifest, not the capsule, so that
    # _resume can name a restore onto another factorization
    geom = getattr(runtime, "geometry", None)
    if geom is not None:
        meta["batch"] = geom.canonical()
    return meta


def prune_checkpoints(checkpoint_dir: str, keep: int) -> None:
    """Retain the ``keep`` most-recent ``step_*`` checkpoints
    (0 = keep all)."""
    if not keep:
        return
    paths = sorted(glob.glob(os.path.join(checkpoint_dir, "step_*.json")))
    for p in paths[:-keep]:
        base = p[:-len(".json")]
        for suffix in (".json", ".npz"):
            try:
                os.remove(base + suffix)
            except OSError:
                pass


def to_disk(state: TrainState, runtime=None):
    """The capsule as the checkpoint holds it, in the reference's layout:
    numpy leaves, or the runtime's own conversion where it has one (the
    ``stream`` runtime's backbone capsule, ``to_reference``)."""
    if runtime is not None and hasattr(runtime, "to_reference"):
        return runtime.to_reference(state)
    return bridge.train_state_to_reference(state)


def from_disk(tree, runtime=None) -> TrainState:
    """A restored (reference-layout) capsule as the port's, on the CPU;
    ``run_from`` moves it to the runtime's device."""
    if runtime is not None and hasattr(runtime, "from_reference"):
        return runtime.from_reference(tree)
    return bridge.train_state_from_jax(tree)


def restore_capsule(path: str, template: TrainState,
                    runtime=None) -> TrainState:
    """A trainer checkpoint restored against ``template`` (any capsule of
    the restoring runtime) with every check of ``checkpoint.io.restore``."""
    return from_disk(ckpt_io.restore(path, to_disk(template, runtime)),
                     runtime)


class LearnerDiverged(RuntimeError):
    """The segment produced non-finite parameters. Raised before the
    capsule is checkpointed, so the divergence never becomes durable.
    Only checked when a fault plan is configured."""


@dataclass
class TrainReport:
    """What ``Trainer.fit`` returns."""
    params: Any
    state: TrainState            # mid-stream continuation capsule
    intervals: int               # total intervals completed (incl. resumed)
    resumed_from: int            # intervals already done at fit() entry
    steps: int                   # env steps executed by THIS fit call
    wall_time: float
    sps: float
    rewards: np.ndarray          # (intervals_this_fit, alpha, n_envs)
    dones: np.ndarray
    episode_returns: np.ndarray  # completion-order, incl. resumed history
    restarts: int = 0            # supervisor recoveries this fit
    recoveries: List[dict] = field(default_factory=list)
    # each: {"failure", "restored_to", "backoff_s", "restore_s"}

    def final_metric(self, n_episodes: int = 100) -> float:
        eps = self.episode_returns
        return float(eps[-n_episodes:].mean()) if len(eps) else float("nan")


class Trainer:
    """Periodic-checkpoint driver over a registered runtime.

    * ``ckpt_every``   — intervals per segment (0: one segment, checkpoint
      only at the end when ``checkpoint_dir`` is set).
    * ``on_segment``   — optional ``callback(intervals_done, RunResult)``
      after each segment's checkpoint is durable. Intermediate segments
      run with ``finalize=False``, so their RunResult.params are
      mid-stream.
    * ``keep``         — most-recent checkpoints retained (0 = all).
    * ``on_interval``  — optional ``callback(interval, {"rewards": (alpha,
      n_envs), "dones": ...})`` per completed interval, global index.
    * ``faults``       — a ``FaultPlan`` or (shared) ``FaultInjector``.
      Arms the ``checkpoint``-site truncation in ``_save`` and, when the
      plan's ``max_restarts > 0``, supervision: a failed segment (any
      exception, ``LearnerDiverged`` included) is absorbed by restoring
      the newest complete, uncorrupt checkpoint and replaying from it,
      with exponential backoff, up to ``max_restarts`` consecutive
      failures. The recovered run's final params and episode-return
      stream equal the fault-free run's. Falling back past a corrupt
      newest checkpoint re-runs reported intervals, so ``on_interval``
      may see an index twice (with identical metrics).
    """

    def __init__(self, runtime: Runtime, checkpoint_dir: Optional[str] = None,
                 ckpt_every: int = 0,
                 on_segment: Optional[Callable[[int, Any], None]] = None,
                 keep: int = 3,
                 on_interval: Optional[Callable[[int, dict], None]] = None,
                 faults: Optional[FaultPlan | FaultInjector] = None):
        self.runtime = runtime
        self.checkpoint_dir = checkpoint_dir
        self.ckpt_every = ckpt_every
        self.on_segment = on_segment
        self.keep = keep
        self.on_interval = on_interval
        if faults is None or isinstance(faults, FaultInjector):
            self.faults = faults
        else:
            self.faults = FaultInjector(FaultPlan.of(faults))
        self._plan = self.faults.plan if self.faults is not None else None

    # ----------------------------------------------------------- ckpt io
    def _ckpt_path(self, intervals: int) -> str:
        return os.path.join(self.checkpoint_dir, f"step_{intervals:08d}")

    def latest_checkpoint(self) -> Optional[str]:
        if not self.checkpoint_dir:
            return None
        return ckpt_io.latest(self.checkpoint_dir)

    def _save(self, state: TrainState, intervals: int,
              stream: evaluate.ReturnStream) -> None:
        meta = checkpoint_metadata(self.runtime, intervals, stream)
        ckpt_io.save(self._ckpt_path(intervals), to_disk(state, self.runtime),
                     metadata=meta)
        if self.faults is not None:
            # checkpoint-site chaos: the atomic write cannot produce a
            # torn file, so the injectable failure is post-write
            # corruption, detected at restore as CheckpointCorrupt
            ev = self.faults.poll("checkpoint", intervals)
            if ev is not None and ev.kind == "truncate":
                npz = self._ckpt_path(intervals) + ".npz"
                with open(npz, "r+b") as f:
                    size = f.seek(0, os.SEEK_END)
                    f.truncate(max(size // 2, 1))
        prune_checkpoints(self.checkpoint_dir, self.keep)

    def _resume(self) -> tuple[Optional[TrainState], int, Optional[dict]]:
        path = self.latest_checkpoint()
        if path is None:
            return None, 0, None
        meta = ckpt_io.load_metadata(path)
        if meta.get("format") != CKPT_FORMAT:
            raise ValueError(
                f"{path} is not a trainer checkpoint "
                f"(format={meta.get('format')!r})")
        cfg = self.runtime.cfg
        # staleness defaults to 1 for checkpoints that predate it; the
        # runtime may differ (the capsule is cross-runtime)
        for key, have, default in (
                ("algorithm", cfg.algorithm, None), ("seed", cfg.seed, None),
                ("alpha", cfg.alpha, None), ("n_envs", cfg.n_envs, None),
                ("staleness", cfg.staleness, 1)):
            if meta.get(key, default) != have:
                raise ValueError(
                    f"resume mismatch: checkpoint has {key}="
                    f"{meta.get(key, default)!r}, runtime has {have!r}")
        # another factorization of the same global batch is a supported
        # restore (bit-exact), announced, never silent
        geom = getattr(self.runtime, "geometry", None)
        saved = meta.get("batch")
        if (geom is not None and saved is not None
                and saved != geom.canonical()):
            print(f"[trainer] resume crosses batch geometries: "
                  f"checkpoint {saved} -> runtime {geom.canonical()} "
                  f"(same global_batch; bit-exact by the scale-out "
                  f"determinism contract)", file=sys.stderr)
        state = restore_capsule(path, self.runtime.state(), self.runtime)
        return state, int(meta["intervals"]), meta.get("metrics")

    # --------------------------------------------------------- recovery
    @staticmethod
    def _check_finite(params) -> None:
        for i, leaf in enumerate(tree_leaves(params)):
            if leaf.is_floating_point() and \
                    not bool(torch.isfinite(leaf.float()).all()):
                raise LearnerDiverged(
                    f"segment produced non-finite parameters (leaf {i})")

    def _recover(self, template: TrainState, start0: int, entry_metrics):
        """Newest complete and uncorrupt checkpoint, walking past damaged
        ones loudly; the last fallback is the fit-entry capsule.
        ``template`` is a CPU snapshot of the entry capsule, not
        ``runtime.state()``: after a failure mid-interval the runtime's
        carry is not to be trusted."""
        if self.checkpoint_dir:
            for path in ckpt_io.complete_checkpoints(self.checkpoint_dir):
                meta = ckpt_io.load_metadata(path)
                if meta.get("format") != CKPT_FORMAT:
                    continue
                try:
                    state = restore_capsule(path, template, self.runtime)
                except ckpt_io.CheckpointCorrupt as e:
                    print(f"[trainer] skipping corrupt checkpoint "
                          f"{os.path.basename(path)}: {e}",
                          file=sys.stderr)
                    continue
                return state, int(meta["intervals"]), meta.get("metrics")
        return tree_map(torch.clone, template), start0, entry_metrics

    # --------------------------------------------------------------- fit
    def fit(self, n_intervals: int, resume: bool = False) -> TrainReport:
        """Train until ``n_intervals`` TOTAL intervals have run (a resumed
        fit counts the checkpointed intervals toward the target)."""
        cfg = self.runtime.cfg
        if not resume and self.latest_checkpoint() is not None:
            # a fresh run among stale checkpoints would let pruning delete
            # the new ones while a later resume picks up the old run
            raise ValueError(
                f"{self.checkpoint_dir} already holds checkpoints "
                f"({os.path.basename(self.latest_checkpoint())}); pass "
                f"resume=True to continue that run, or point "
                f"checkpoint_dir at a fresh directory")
        state, start, metric_state = (self._resume() if resume
                                      else (None, 0, None))
        stream = evaluate.ReturnStream(cfg.n_envs)
        if metric_state is not None:
            stream.load_state_dict(metric_state)
        if state is None:
            state = self.runtime.state()   # fresh initial capsule
        plan = self._plan
        supervised = plan is not None and plan.max_restarts > 0
        if supervised:
            # the restore template and the last fallback point, on the host
            entry = tree_map(lambda t: t.detach().cpu().clone(), state)
            entry_metrics = stream.state_dict()
        done = start
        out = None
        # committed segments as (done_after, rewards, dones, steps): a
        # recovery to an older checkpoint truncates the list, so the
        # reported streams are the one surviving timeline
        segs: list = []
        steps_executed = 0
        consec = 0
        restarts = 0
        recoveries: list = []
        t0 = time.perf_counter()
        while done < n_intervals:
            chunk = min(self.ckpt_every or (n_intervals - done),
                        n_intervals - done)
            try:
                # only the final segment pays the reporting-only trailing
                # learner pass
                out = self.runtime.run_from(
                    state, chunk, finalize=(done + chunk >= n_intervals))
                if plan is not None:
                    # before the capsule is saved: a diverged step must
                    # never become durable
                    self._check_finite(out.params)
            except Exception as e:
                if not supervised or consec >= plan.max_restarts:
                    raise
                consec += 1
                restarts += 1
                delay = min(plan.backoff * (2 ** (consec - 1)),
                            plan.backoff_cap)
                print(f"[trainer] segment at interval {done} failed "
                      f"({type(e).__name__}: {e}); restart "
                      f"{consec}/{plan.max_restarts} after "
                      f"{delay:.3f}s backoff", file=sys.stderr)
                time.sleep(delay)
                r0 = time.perf_counter()
                state, done, mstate = self._recover(
                    entry, start, entry_metrics)
                stream = evaluate.ReturnStream(cfg.n_envs)
                if mstate is not None:
                    stream.load_state_dict(mstate)
                segs = [s for s in segs if s[0] <= done]
                recoveries.append({
                    "failure": f"{type(e).__name__}: {e}",
                    "restored_to": done,
                    "backoff_s": delay,
                    "restore_s": time.perf_counter() - r0,
                })
                continue
            consec = 0
            if self.on_interval is not None:
                for i, metrics in out.interval_metrics():
                    self.on_interval(done + i, metrics)
            done += chunk
            state = self.runtime.state()
            stream.extend(out.rewards, out.dones)
            segs.append((done, out.rewards, out.dones, out.steps))
            steps_executed += out.steps
            if self.checkpoint_dir:
                self._save(state, done, stream)
            if self.on_segment is not None:
                self.on_segment(done, out)
        if out is None:
            # resumed at or past the target: report the restored state's
            # parameters through a 0-interval segment
            out = self.runtime.run_from(state, 0)
        wall = time.perf_counter() - t0
        empty = np.zeros((0, cfg.alpha, cfg.n_envs), np.float32)
        rewards_log = [s[1] for s in segs]
        dones_log = [s[2] for s in segs]
        return TrainReport(
            params=out.params, state=state, intervals=done,
            resumed_from=start, steps=steps_executed, wall_time=wall,
            sps=steps_executed / max(wall, 1e-9),
            rewards=np.concatenate(rewards_log) if rewards_log else empty,
            dones=np.concatenate(dones_log) if dones_log else empty,
            episode_returns=stream.returns,
            restarts=restarts, recoveries=recoveries)
