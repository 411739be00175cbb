"""What the benchmark reads from a torch.profiler trace of its window.

The window is marked from the benchmark's own files: a
``bench.step_end`` range recorded on the host as each step's observer
runs, which is after the step's last kernel has finished (the observer
reads the step's loss, a device-to-host copy that waits for the
stream). So the kernels of window step ``i`` are those launched between
marker ``i`` and marker ``i + 1``; a kernel is placed by its launch's
host time (the CUDA API call that shares its correlation id),
or by its own start where the trace links no launch.
"""
from __future__ import annotations

import bisect
import json
import re
from collections import Counter, defaultdict
from pathlib import Path
from typing import Dict, List, Optional

MARKER = "bench.step_end"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "python_function",
              "cuda_runtime", "cuda_driver")


def kernel_name(name: str) -> str:
    """A kernel's bare name: no return type, namespace, template arguments
    or parameter list."""
    name = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::",
                                                ""))
    m = re.match(r"[\w:]+", name)
    return (m.group(0) if m else name).rsplit("::", 1)[-1]


def op_name(name: str) -> str:
    """A device operation's name for the breakdown: the bare name, and for
    PyTorch's generic kernels the functors or ops in their template
    arguments (``vectorized_elementwise_kernel<AUnaryFunctor,MulFunctor>``),
    which say what the kernel computes."""
    tags = list(dict.fromkeys(re.findall(
        r"(\w*Functor\w*|\w+_kernel_cuda|\w+_kernel_impl|\w+Ops)\b",
        name)))[:3]
    bare = kernel_name(name)
    return f"{bare}<{','.join(tags)}>" if tags else bare


class Window:
    """The kernels of the traced window's steps, and its length."""

    def __init__(self, events: List[dict]):
        markers = sorted(e["ts"] for e in events
                         if e.get("name") == MARKER
                         and e.get("cat") == "user_annotation")
        if len(markers) < 2:
            raise ValueError(f"the trace holds {len(markers)} step markers; "
                             "a window needs two or more")
        self.start, self.end = markers[0], markers[-1]
        self.steps = len(markers) - 1
        launch = {e["args"]["correlation"]: e["ts"] for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        # (bare name, start us, dur us, step): the kernels, and every
        # device operation (kernels, copies, fills)
        self.kernels, self.ops = [], []
        self.raw: Dict[str, str] = {}     # a full name for each bare one
        for e in events:
            if e.get("cat") not in _DEVICE_CATS or "dur" not in e:
                continue
            at = launch.get(e.get("args", {}).get("correlation"), e["ts"])
            step = bisect.bisect_right(markers, at) - 1
            if 0 <= step < self.steps:
                op = (op_name(e["name"]), e["ts"], e["dur"], step)
                self.raw.setdefault(op[0], e["name"])
                self.ops.append(op)
                if e["cat"] == "kernel":
                    self.kernels.append((kernel_name(e["name"]),) + op[1:])
        self.host = [e for e in events if e.get("cat") in _HOST_CATS
                     and "dur" in e and e.get("name") != MARKER]

    # ------------------------------------------------------------ totals
    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def busy_intervals(self) -> List[tuple]:
        """The union of the window's device operations' intervals, clipped
        to it."""
        spans = sorted((max(s, self.start), min(s + d, self.end))
                       for _, s, d, _ in self.ops)
        out: List[list] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def launches_by_step(self) -> List[int]:
        n = Counter(step for *_, step in self.kernels)
        return [n[i] for i in range(self.steps)]

    def kernel_seconds(self, pattern: str) -> float:
        """Summed device seconds of the kernels whose bare name matches
        ``pattern`` (a regular expression, matched from the start)."""
        rx = re.compile(pattern)
        return sum(d for n, _, d, _ in self.kernels if rx.match(n)) / 1e6

    def kernel_count(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for n, *_ in self.kernels if rx.match(n))

    # ------------------------------------------------------------ breakdown
    def device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for n, _, d, _ in self.ops:
            by[n] += d / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The window's idle time (no device operation), summed by the
        innermost host operation running at each gap's middle; the ``top``
        largest, with the number of gaps in the name."""
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        host = sorted(self.host, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        total, count = defaultdict(float), Counter()
        for a, b in gaps:
            mid = (a + b) / 2
            name = _innermost(host, starts, mid) or "no host op"
            total[name] += (b - a) / 1e6
            count[name] += 1
        return [[f"{n} x{count[n]}", s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def _innermost(host: List[dict], starts: List[float],
               t: float) -> Optional[str]:
    """The host event covering time ``t`` that started last: the innermost
    of nested ones. Looks back over the last 2000 events started."""
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - 2000):i]):
        if e["ts"] + e["dur"] >= t:
            return e["name"]
    return None


def load(path: Path) -> List[dict]:
    with open(path) as f:
        return json.load(f).get("traceEvents", [])
