"""One run of a cell: set-up, the measured (or traced) window, and the
check of the timed path against the plain reference.

The program is built through its public entry, as its training launcher
builds it: env x policy ``backbone`` (the hand-written kernels on) x
Adam x a2c x the ``stream`` runtime, no mesh. Its workload is the
traffic pool (``rollouts``), registered as an env; its weights are the
benchmark's own (``weights``), written into the runtime's initial host
copy before the run. One ``Session.run`` call drives everything: the
warm-up steps, of which the first two are compared with the
reference, then the window, which closes at the first step that ends
``seconds`` after it opened. A step's end is its ``on_interval``
observer, which runs after the step's loss has reached the host.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from benchlib import check, counts, rollouts, trace, weights
from reference import model as ref_model

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the steps the reference follows; all lie in the warm-up. Two: both
# losses are taken at the initial weights (the delayed gradient's), and
# the reference's fp32 steps take as long as the window
COMPARED = 2
# the traced window's length at most (its trace is read in the run)
TRACE_SECONDS = 10.0
# a traced window holds at least this many steps
TRACE_MIN_STEPS = 3
ENV_NAME = "bench.pool"
# the a2c loss's terms, as the program's stats and the reference name them
TERMS = ("loss", "pg", "value", "entropy")


@dataclass
class Cell:
    name: str
    cfg: dict            # bench/configs/<config>.json
    traffic: dict        # bench/traffic/<traffic>.json
    spec: dict           # bench/workloads/<cell>.json
    end_to_end: List[str]
    per_layer: List[str]
    chips: int = 1


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _in_cell(metric: dict, name: str) -> bool:
    return "workloads" not in metric or name in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` and the files it names."""
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{[w['name'] for w in bench['workloads']]}")
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    spec = _json(root / "bench" / "workloads" / f"{name}.json")
    if (spec["config"], spec["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise SystemExit(f"bench/workloads/{name}.json names another "
                         "config or traffic than BENCHMARK.json")
    return Cell(name=name, cfg=_json(root / config["file"]),
                traffic=rollouts.load(root / "bench" / "traffic"
                                      / f"{entry['traffic']}.json"),
                spec=spec,
                end_to_end=[m["name"] for m in bench["end_to_end"]
                            if _in_cell(m, name)],
                per_layer=[m["name"] for m in bench["per_layer"]
                           if _in_cell(m, name)],
                chips=entry["chips"])


def metric_module(name: str):
    """``bench/metrics/<name>.py``, loaded by path."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------ the program
def _build(cell: Cell, pool, device):
    """The program's ``Session`` over the pool, built as its launcher
    builds one."""
    from repro_torch import api, envs
    cfg, tr = cell.cfg, cell.traffic
    envs.register_env(ENV_NAME)(
        lambda **kw: rollouts.PoolStream(pool, **kw))
    port = dict(cfg["port"])
    spec = api.ExperimentSpec(
        env={"name": ENV_NAME, "kwargs": {"vocab": cfg["vocab_size"],
                                          "batch": tr["batch"],
                                          "seq": tr["seq"]}},
        policy={"name": "backbone",
                "kwargs": {"use_pallas_attention": True, **port}},
        optimizer={"name": "adam", "kwargs": {"lr": cell.spec["lr"],
                                              **ref_model.ADAM}},
        algorithm="a2c",
        runtime={"name": "stream", "kwargs": {"mesh": None}},
        intervals=1)
    session = api.build(spec, device=str(device))
    mc = session.policy.config
    have = dict(hidden_size=mc.d_model, num_hidden_layers=mc.n_layers,
                vocab_size=mc.vocab_size, intermediate_size=mc.d_ff,
                torch_dtype=mc.dtype)
    want = {k: cfg[k] for k in have}
    if have != want:
        raise SystemExit(f"the program's model {have} is not the "
                         f"configuration's {want}")
    return session


def _load_weights(session, specs, seed: int, device) -> None:
    """The benchmark's weights into the runtime's initial host copy, which
    ``run`` places on the device."""
    host = session.runtime.params0
    got = {n: (tuple(t.shape), t.dtype) for n, t in host.items()}
    want = {n: (tuple(s), dt) for n, s, dt, _ in specs}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:6]
        raise SystemExit(f"the program's parameters are not the "
                         f"reference's layout: {diff}")
    theta = weights.make(specs, seed, device)
    for n, t in theta.items():
        host[n].copy_(t)
    del theta


def _frozen(opt):
    """``opt`` whose in-place step leaves the state unchanged (a fault)."""
    def update_(grads, state, params, out):
        for p, o in zip(params.values(), out.values()):
            o.copy_(p)
        return state
    return opt._replace(update_=update_)


def _undelayed(rt) -> None:
    """``rt``'s step with its gradient taken at the parameters it updates,
    not at the one-update-old ones (a fault: the learner without its
    delay)."""
    rt._build()
    step = rt._step

    def undelayed(dg, batch):
        for n, p in dg.params.items():
            dg.params_prev[n].copy_(p)
        return step(dg, batch)
    rt._step = undelayed


def _half_batch(batch: dict) -> dict:
    """``batch`` with its second half of rows out of the loss (a fault)."""
    mask = batch["loss_mask"].clone()
    mask[mask.shape[0] // 2:] = 0
    return dict(batch, loss_mask=mask)


class _Closed(Exception):
    """Raised by the observer to end ``Session.run`` at the window's end."""


def _norms(names, leaf: Callable[[str], torch.Tensor],
           scale: float = 1.0) -> Dict[str, float]:
    """{name: scale x ||leaf(name)||}, one leaf's tensor alive at a time."""
    names = list(names)
    vals = torch.stack([torch.linalg.vector_norm(leaf(n).float())
                        for n in names]).tolist()
    return {n: v * scale for n, v in zip(names, vals)}


# elements of a leaf a change norm takes at a time: its float32 slices
# (the device's and the host original's, and their difference) stay
# under 50 MiB, so the check adds nothing that counts to the peak
CHANGE_SLICE = 1 << 22


def _change_norms(now: Dict[str, torch.Tensor],
                  then: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: ||now[name] - then[name]||} in float32, by slices of
    ``CHANGE_SLICE`` elements; ``then`` may live on the host."""
    out = {}
    for n, a in now.items():
        a, b = a.reshape(-1), then[n].reshape(-1)
        sq = torch.zeros((), dtype=torch.float64, device=a.device)
        for i in range(0, a.numel(), CHANGE_SLICE):
            d = a[i:i + CHANGE_SLICE].float() \
                - b[i:i + CHANGE_SLICE].to(a.device).float()
            sq += torch.linalg.vector_norm(d).double() ** 2
        out[n] = sq
    vals = torch.stack(list(out.values())).sqrt().tolist()
    return dict(zip(out, vals))


class _Observer:
    """The ``on_interval`` observer: the compared steps' readings, the
    window's clock, and in a traced run the profiler and step markers."""

    def __init__(self, session, warmup: int, seconds: float,
                 traced: bool):
        if warmup < COMPARED:
            raise ValueError(f"warmup_steps {warmup} < {COMPARED}")
        self.rt = session.runtime
        self.warmup, self.seconds, self.traced = warmup, seconds, traced
        self.terms: List[dict] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.prof = None
        self.t_first = self.t_start = self.t_end = None
        self.step_ends: List[float] = []
        self.steps = 0
        self.nonfinite = 0
        # the device's bytes allocated and its peak before and after the
        # change norms: the check's own share of ``peak_mem_gib``
        self.check_mem = None

    def _mark(self) -> None:
        if self.prof is not None:
            with torch.profiler.record_function(trace.MARKER):
                pass

    def __call__(self, m: dict) -> None:
        j = m["interval"]
        now = time.perf_counter()
        self.nonfinite += not math.isfinite(m["loss"])
        if j == 0:
            self.t_first = now
        if j < COMPARED:
            self.terms.append({k: m[k] for k in TERMS})
        if j == 0:
            # Adam's first moment after one step is (1 - b1) g
            m1 = self.rt.dg.opt_state["m"]
            self.grad = _norms(m1, m1.__getitem__,
                               1.0 / (1.0 - ref_model.ADAM["b1"]))
        if j == COMPARED - 1:
            cuda = self.rt.device.type == "cuda"
            mem = [torch.cuda.memory_allocated(self.rt.device),
                   torch.cuda.max_memory_allocated(self.rt.device)] \
                if cuda else []
            self.change = _change_norms(self.rt.dg.params, self.rt.params0)
            if cuda:
                self.check_mem = mem + [
                    torch.cuda.max_memory_allocated(self.rt.device)]
        if j == self.warmup - 1:
            if self.traced:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU]
                if self.rt.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                self.prof = profile(activities=acts)
                self.prof.start()
            self._mark()
            self.t_start = time.perf_counter()
            return
        if j < self.warmup:
            return
        self._mark()
        self.steps += 1
        now = time.perf_counter()
        self.step_ends.append(now)
        length = min(self.seconds, TRACE_SECONDS) if self.traced \
            else self.seconds
        if now - self.t_start >= length and (
                not self.traced or self.steps >= TRACE_MIN_STEPS):
            self.t_end = now
            if self.prof is not None:
                self.prof.stop()
            raise _Closed


# ------------------------------------------------------------ the reference
def reference_readings(cell: Cell, seed: int, device, order: List[int],
                       precision: str = "fp32",
                       log: Callable[[str], None] = lambda s: None) -> dict:
    """The reference's readings over the pool's batches ``order[:COMPARED]``
    from the seed's weights: each step's loss and its terms, the first
    gradient's norm by leaf, each leaf's change over the steps."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    specs = ref_model.param_specs(cell.cfg)
    pool = rollouts.batches(cell.traffic, cell.cfg["vocab_size"], seed)
    ref = ref_model.Reference(cell.cfg, weights.make(specs, seed, device),
                              cell.spec["lr"], precision)
    grad: Dict[str, float] = {}
    terms = []
    for j, i in enumerate(order[:COMPARED]):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in pool[i].items()}
        on_grad = None
        if j == 0:
            def on_grad(n, g):
                grad[n] = torch.linalg.vector_norm(g)
        terms.append(ref.step(batch, on_grad))
        log(f"reference ({precision}) step {j + 1}: loss "
            f"{terms[-1]['loss']:.6f}, {time.perf_counter() - t0:.1f} s")
    final = ref.params
    del ref
    gc.collect()
    theta0 = weights.make(specs, seed, device)
    change = _change_norms(final, theta0)
    return {"terms": terms, "grad": {n: float(g) for n, g in grad.items()},
            "change": change}


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


# ------------------------------------------------------------ one run
FAULTS = ("half_batch", "frozen", "undelayed")


def setup(cell: Cell, seed: int, device, fault: Optional[str] = None):
    """The program's ``Session`` for the cell, its pool and weights made
    from the seed; ``fault`` (one of ``FAULTS``) breaks the timed path on
    purpose."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    pool = rollouts.on_device(
        rollouts.batches(cell.traffic, cell.cfg["vocab_size"], seed),
        device)
    if fault == "half_batch":
        pool = [_half_batch(b) for b in pool]
    session = _build(cell, pool, device)
    _load_weights(session, ref_model.param_specs(cell.cfg), seed, device)
    if fault == "frozen":
        session.runtime.opt = _frozen(session.runtime.opt)
    elif fault == "undelayed":
        _undelayed(session.runtime)
    return session


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_process: float, fault: Optional[str] = None,
        log: Callable[[str], None] = lambda s: None) -> dict:
    """One run; returns the result line's object. ``t_process`` is the
    process's start on ``time.perf_counter``'s clock. ``fault`` (one of
    ``FAULTS``) breaks the timed path on purpose."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    tr, cfg = cell.traffic, cell.cfg
    t_setup = time.perf_counter()
    session = setup(cell, seed, device, fault)
    obs = _Observer(session, cell.spec["warmup_steps"], seconds, traced)
    session.on_interval(obs)
    t_run = time.perf_counter()
    log(f"set-up: imports {t_setup - t_process:.2f} s, pool, build and "
        f"weights {t_run - t_setup:.2f} s")
    try:
        session.run(1 << 40)
        raise RuntimeError("the run ended before its window closed")
    except _Closed:
        pass
    if cuda:
        torch.cuda.synchronize(device)
    window_s = obs.t_end - obs.t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    steps = [b - a for a, b in zip([obs.t_start] + obs.step_ends,
                                   obs.step_ends)]
    log(f"set-up: first step {obs.t_first - t_run:.2f} s, warm-up to the "
        f"window {obs.t_start - obs.t_first:.2f} s; window {window_s:.3f} s,"
        f" {obs.steps} steps, step s min {min(steps):.4f} median "
        f"{statistics.median(steps):.4f} max {max(steps):.4f}")
    if obs.check_mem:
        alloc, before, after = (b / 2 ** 30 for b in obs.check_mem)
        log(f"memory: {alloc:.3f} GiB allocated at the change norms, peak "
            f"{before:.3f} GiB before them and {after:.3f} after, "
            f"{peak / 2 ** 30:.3f} at the window's close")
    tokens = tr["batch"] * tr["seq"]
    metrics: Dict[str, dict] = {}
    out = {"correct": False, "attempted": cell.spec["warmup_steps"]
           + obs.steps, "failed": obs.nonfinite, "metrics": metrics}
    if traced:
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            obs.prof.export_chrome_trace(str(path))
            window = trace.Window(trace.load(path))
        ctx = SimpleNamespace(cfg=cfg, traffic=tr, window=window,
                              counts=counts)
        for name in cell.per_layer:
            mod = metric_module(name)
            value = mod.read(ctx)
            if value is None:
                log(f"{name}: not measured")
                continue
            metrics[name] = {"value": value, "unit": mod.UNIT}
        log(f"trace: {window.steps} steps, {len(window.kernels)} kernels, "
            f"per step {window.launches_by_step()}")
        for name, seconds in window.device_ops():
            log(f"trace: {seconds:.4f} s {name}: {window.raw[name][:400]}")
        out["breakdown"] = {"device_ops": window.device_ops(),
                            "idle_gaps": window.idle_gaps()}
        busy = {"busy_s": window.busy_s, "window_s": window.window_s}
    else:
        e2e = {"train_tokens_per_s": (obs.steps * tokens / window_s,
                                      "tokens/s"),
               "peak_mem_gib": (peak / 2 ** 30, "GiB"),
               "setup_s": (obs.t_start - t_process, "s")}
        for name in cell.end_to_end:
            value, unit = e2e[name]
            metrics[name] = {"value": value, "unit": unit}
        busy = {}
    out["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": (torch.cuda.get_device_name(device) if cuda
                              else "cpu"),
                     "count": 1, "memory_peak_bytes": peak, **busy}
    order = session.runtime.stream.served
    prog = {"terms": obs.terms, "grad": obs.grad, "change": obs.change}
    # the program's state goes before the reference runs
    del session, obs
    _free(device)
    ref = reference_readings(cell, seed, device, order, log=log)
    log("terms: " + json.dumps({"program": prog["terms"],
                                "reference": ref["terms"]}))
    for key in ("grad", "change"):
        if set(prog[key]) == set(ref[key]):
            log(f"{key}: worst leaves (gap, program, reference): " + "; ".join(
                f"{n} {g:.4g} {p:.5g} {r:.5g}"
                for n, g, p, r in check.ranked(prog, ref, key)))
    for stat in ("worst", "median"):
        log(f"{stat} leaf: " + ", ".join(
            f"{k} {v['value']:.4g}" for k, v in check.readings(
                prog, ref, dict.fromkeys(("grad", "change"), stat)).items()))
    ok, checks = check.verdict(
        check.readings(prog, ref, cell.spec.get("leaf_stat")),
        cell.spec["limits"])
    out["correct"] = ok and out["failed"] == 0
    out["checks"] = checks
    return out
