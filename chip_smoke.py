"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. the card: nvidia-smi name and power limit, torch and CUDA versions;
2. the build: every hand-written kernel of the serving paths
   (flash_attention, lru_scan, wkv6), one nvcc per source, all started
   together, with each compiler report (registers, spills), the count
   of tensor-core instructions (HGMMA, HMMA) in each library's SASS and
   of TMA loads (UTMALDG) in lru_scan's;
3. each kernel against its plain PyTorch version on the card, at the
   reference test cases, at shapes off the TPU kernels' block multiples
   and at the shapes the main paths give it; flash attention also on
   strided views in the model's layout (ragged S, window, soft-cap, every
   bf16 head dim), wkv6 also around its chunk length and with fast decay
   (w down to 1e-4, and w = 0), and the chunked wkv6 against its plain
   chunked form; lru_scan bit for bit (``torch.equal``) on both of its
   kernels, the TMA ring and the per-thread one (ragged tiles, and rows
   and bases that TMA refuses), each case printing the route it took;
4. the main paths, each through ``repro_torch.launch.serve.main`` at full
   width and full depth with random weights from seed 0, 4 prompts of 500
   tokens, 32 generated: StarCoder2-3B (flash attention in 30 layers),
   RecurrentGemma-9B (lru_scan in 26 RG-LRU layers, flash attention in 12
   local-attention layers) and RWKV-6-7B (wkv6 in 32 layers, prefill and
   every decode step). The kernel launch counts are zeroed just before
   each run and read just after; then per prefill and per decode step.
   The prefill logits are held against the same weights run with the
   plain versions (for RWKV-6 beside the distance a reordering of the
   plain wkv6's sum alone makes), a sampled run is repeated to show its
   tokens do not change, the full-width model in fp32 is held against
   its plain-version run, and a reduced fp32 config is held against the
   CPU run of the same weights. Each model is freed before the next;
5. times, beside the card's name and power limit: prefill, decode, and
   each kernel's time against its bound, its plain version and the
   library call that computes the same function, where one exists
   (lru_scan: both kernels, in turns, with their GB/s). A
   bound counts the operations at the rate of the units that run them
   (bf16 or TF32 tensor cores, fp32 CUDA cores); wkv6's CUDA-core reading
   is printed beside its tensor-core one. Each profile window also prints
   the port's own kernels' share of the device time;
6. the training interval (``phase_train``): each run built by
   ``api.build(spec, device=...)``, the user's path (the ``mesh`` runtime,
   learner and rollout halves on two CUDA streams). On the goldens'
   configuration (catch, mlp, rmsprop, alpha 4, n_envs 4, seed 3, 3
   intervals) for a2c, ppo and vtrace the card's reward/done streams
   equal the port's CPU run of the same params and the params are within
   1e-5; ``examples/specs/quickstart.json`` runs twice on the card
   bit-identically, its host and device env backends give equal streams,
   and a K=2 run applies 40 updates; the device backend at n_envs 1024 (alpha 8, 10 intervals)
   gives env steps/s with a warm-up run excluded, and a profile window
   the device busy share and each stream's kernel time; the paper CNN at
   its published widths runs one ``actor_forward`` and one learner pass
   on a synthetic trajectory (alpha 5, n_envs 16, (84, 84, 4)), held
   against the port's CPU at 1e-4 relative, with times. The path
   launches none of the port's kernels, and the counts say so;
7. the entry point (``phase_run``): ``python -m repro_torch.launch.run
   --spec examples/specs/quickstart.json`` with no other flag; then with
   ``--ckpt-dir --ckpt-every 10 --intervals 20`` and again with
   ``--resume --intervals 40``, whose last checkpoint (the reference's
   file format) equals an uninterrupted ``Session.fit(40)`` on the card:
   every capsule leaf ``torch.equal``, the episode-return stream equal; a
   fit under a fault plan (the checkpoint at 20 truncated, the segment
   from 20 failed once, ``max_restarts`` 2) recovers past the corrupt
   checkpoint to the fault-free fit's params and returns; gridmaze
   (``examples/specs/pool_b.json``: scenario 7, mlp, ppo, K=2; the same
   with the CPU tests' reduced CNN and with ``examples/atari_a2c.py``'s
   CNN) on the host and device env backends, card against the port's
   CPU (TF32 off): streams exact, params within 1e-5 (the atari_a2c CNN:
   its first learner pass's gradients within 1e-4 relative, its params'
   distance printed); the device-backend gridmaze at n_envs 1024, env
   steps/s over 3 runs after a warm-up. The launch counts of the port's
   kernels over all of that stay 0. Then the kernels' gradient guard:
   each kernel, called on the card with an input that requires grad
   under grad mode (and under ``torch.func.grad``), raises; the same
   call under ``inference_mode`` launches once and matches its plain
   version.

The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Needs CUDA; imports nothing of jax.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# cuBLAS gives the same bits on every stream only with a fixed workspace,
# set before the first handle is made (the training phase runs its
# learner and rollout on two streams)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and FLOP/s by the units
# that do the work (bf16 and TF32 on the tensor cores; fp32 on the CUDA
# cores).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, "tf32": 495e12, torch.float32: 67e12}

# (B, S, H, KV, Dh, causal, window, cap, bq, bk, dtype): the reference's
# FLASH_CASES (tests/test_kernels.py), cases off the block sizes and at
# Dh=256, and the main paths' prefill shapes. The kernel takes S as it is;
# the plain version pads it to the block (S=500 to 512, kv_len=500).
FLASH_CASES = [
    (1, 64, 2, 2, 32, True, 0, 0.0, 32, 32, torch.float32),
    (2, 128, 4, 2, 64, True, 0, 0.0, 64, 64, torch.float32),
    (1, 128, 4, 1, 32, True, 64, 0.0, 32, 64, torch.float32),
    (2, 64, 2, 2, 16, False, 0, 0.0, 32, 32, torch.float32),
    (1, 96, 4, 4, 32, True, 0, 50.0, 32, 32, torch.float32),
    (2, 128, 4, 2, 64, True, 0, 0.0, 64, 64, torch.bfloat16),
    (1, 80, 2, 1, 16, True, 32, 0.0, 16, 16, torch.bfloat16),
    (1, 80, 2, 1, 16, True, 32, 0.0, 32, 32, torch.float32),
    (2, 192, 4, 2, 256, True, 0, 0.0, 128, 128, torch.bfloat16),
    (2, 192, 4, 2, 256, False, 0, 0.0, 128, 128, torch.float32),
]
# the model's layout as strided views (q, k, v slices of one fused
# (B, S, H + 2 KV, Dh) tensor), unpadded: ragged S = 500 and 80, window < S,
# soft-cap, every bf16 head dim the kernel takes, and fp32
FLASH_STRIDED = [
    (2, 500, 8, 2, 16, True, 0, 0.0, 128, 128, torch.bfloat16),
    (2, 80, 4, 1, 64, True, 32, 0.0, 128, 128, torch.bfloat16),
    (1, 500, 4, 2, 128, True, 200, 30.0, 128, 128, torch.bfloat16),
    (2, 500, 4, 1, 256, True, 0, 50.0, 128, 128, torch.bfloat16),
    (2, 80, 4, 4, 32, False, 0, 0.0, 128, 128, torch.bfloat16),
    (1, 80, 4, 2, 256, True, 48, 20.0, 128, 128, torch.bfloat16),
    (2, 500, 4, 2, 64, True, 100, 20.0, 128, 128, torch.float32),
]
MAIN = (4, 500, 24, 2, 128, True, 0, 0.0, 128, 128, torch.bfloat16)
# RecurrentGemma-9B's local attention: MQA, Dh=256, window 2048
RG_ATTN = (4, 500, 16, 1, 256, True, 2048, 0.0, 128, 128, torch.bfloat16)

# (B, S, D, dtype): the reference's LRU_CASES (chunk and bd do not apply),
# shapes off the TPU kernel's block multiples, and the RG-LRU prefill shape
LRU_CASES = [
    (1, 32, 16, torch.float32),
    (2, 64, 32, torch.float32),
    (2, 128, 64, torch.float32),
    (1, 64, 48, torch.float32),
    (2, 64, 32, torch.bfloat16),
    (2, 50, 48, torch.float32),
    (3, 300, 600, torch.bfloat16),
]
LRU_MAIN = (4, 500, 4096, torch.float32)
# the route each of these must take (kernel.use_tma): ragged tiles on the
# TMA kernel (S not a multiple of its 32 steps, D not of its 128 channels),
# and rows that are not a multiple of 16 bytes (45 * 4, 4100 * 2) on the
# per-thread kernel
LRU_ROUTES = {
    (2, 33, 200, torch.float32): "tma",
    (1, 500, 4104, torch.bfloat16): "tma",
    (2, 50, 45, torch.float32): "per-thread",
    (1, 500, 4100, torch.bfloat16): "per-thread",
    LRU_MAIN: "tma",
}
# a and b of different dtypes (y takes a's), on the TMA kernel
LRU_MIXED = [(2, 70, 136, torch.float32, torch.bfloat16),
             (2, 70, 136, torch.bfloat16, torch.float32)]
# contiguous a, b or both whose base lies one element into its buffer (a
# 4-byte base: TMA refuses it), on the per-thread kernel
LRU_SHIFTED = (1, 64, 4096, torch.float32)
LRU_SHIFTS = ("a", "b", "ab")

# (B, T, H, N, dtype): the reference's WKV_CASES, T off the chunk, T=1,
# and the RWKV-6 prefill and decode shapes (w always fp32)
WKV_CASES = [
    (1, 16, 1, 8, torch.float32),
    (2, 32, 2, 8, torch.float32),
    (2, 64, 4, 16, torch.float32),
    (1, 32, 2, 16, torch.bfloat16),
    (2, 50, 2, 32, torch.float32),
    (2, 1, 4, 64, torch.float32),
]
WKV_MAIN = (4, 500, 64, 64, torch.bfloat16)
WKV_DECODE = (4, 1, 64, 64, torch.bfloat16)
# the prefill shape in fp32, held at 1e-5 of the output's largest value: an
# error that bf16's 5e-2 hides would show here. Elementwise 1e-5 does not
# apply: 500 steps of 64-term sums of state entries far above 1 differ by
# more than 1e-5 in fp32 between two summation orders
WKV_MAIN32 = (4, 500, 64, 64, torch.float32)
WKV_REL_TOL = 1e-5
# around the chunked kernel's chunk C = 32 (C - 1 runs the recurrent
# kernel, C and C + 1 the chunked one) and at the prefill length, in both
# dtypes, with the reference's w in (0.49, 0.99) and with fast decay, w
# uniform in (1e-4, 0.999): there a chunked form that split
# 2^{P[t] - P[s]} into 2^{P[t]} 2^{-P[s]} would overflow; and that with a
# tenth of the w exactly 0 (the model's exp(-exp(d)) rounds to 0 once d
# passes ~4.6), where log2 w = -inf. Held at the WKV_REL_TOL measure in
# fp32 (the reason above) and at 5e-2 in bf16
WKV_EDGE = [(2, T, 4, 64, dt) for T in (31, 32, 33, 500)
            for dt in (torch.float32, torch.bfloat16)]

BATCH, PROMPT, GEN = 4, 500, 32
# flash kernel vs plain version: tests/test_kernels.py's tolerances. In
# bf16 the kernel, as the TPU kernel, rounds P to bf16 before P V; the
# plain version keeps it in fp32
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
SCAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}  # test_kernels.py

SOURCES = {
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:88"),
    "lru_scan": ("src/repro_torch/kernels/lru_scan/csrc/lru_scan.cu",
                 "src/repro/kernels/lru_scan/kernel.py:42"),
    "wkv6": ("src/repro_torch/kernels/wkv6/csrc/wkv6.cu",
             "src/repro/kernels/wkv6/kernel.py:52"),
}

# kernels whose libraries must hold tensor-core instructions
TENSOR_CORE_KERNELS = ("flash_attention", "wkv6")

# arch -> launches expected (in serve.main: prefill + GEN-1 decode steps,
# per prefill, per decode step); kernels not named must launch 0 times
SERVE_PATHS = {
    "starcoder2-3b": ({"flash_attention": 30}, {"flash_attention": 30}, {}),
    "recurrentgemma-9b": ({"flash_attention": 12, "lru_scan": 26},
                          {"flash_attention": 12, "lru_scan": 26}, {}),
    "rwkv6-7b": ({"wkv6": 32 + (GEN - 1) * 32}, {"wkv6": 32}, {"wkv6": 32}),
}


# the training phase: the goldens' configuration (tests/test_goldens.py)
TRAIN_ALGORITHMS = ("a2c", "ppo", "vtrace")
GOLDEN = dict(alpha=4, n_envs=4, seed=3)
GOLDEN_INTERVALS = 3
PARAMS_TOL = 1e-5            # card vs CPU, the goldens' final params
QUICKSTART = ROOT / "examples" / "specs" / "quickstart.json"
SCALE = dict(alpha=8, n_envs=1024, intervals=10)
CNN_TRAJ = dict(alpha=5, n_envs=16)
CNN_REL_TOL = 1e-4           # card vs CPU, paper CNN at fp32, TF32 off

# the entry point: launcher segments (stop at RUN_STOP, resume to
# RUN_TOTAL, a checkpoint every RUN_EVERY), the fault plan's truncated
# checkpoint and failed segment, gridmaze cells, the guard's cases
RUN_STOP, RUN_TOTAL, RUN_EVERY = 20, 40, 10
POOL_B = ROOT / "examples" / "specs" / "pool_b.json"
# gridmaze's CNNs on its (9, 9, 3) boards: the reduced one of
# tests/test_torch_gridmaze_interval.py, held at PARAMS_TOL; and
# examples/atari_a2c.py's, whose params after rmsprop steps are not a
# well-conditioned comparison at 1e-5 (PERF.md §6): its streams are
# held exact, its first learner pass's gradients at CNN_REL_TOL, and its
# params' distance is printed
GRIDMAZE_CNNS = {
    "cnn-reduced": {"name": "cnn", "kwargs": {"conv_filters": [4, 8],
                                              "conv_sizes": [3, 3],
                                              "conv_strides": [1, 1],
                                              "hidden": 16}},
    "cnn-atari_a2c": {"name": "cnn", "kwargs": {"conv_sizes": [3, 3, 3],
                                                "conv_strides": [1, 1, 1],
                                                "hidden": 128}},
}
GRIDMAZE_SCALE = dict(alpha=8, n_envs=1024, intervals=10)
GUARD_CASES = {"flash_attention": FLASH_CASES[1], "lru_scan": LRU_CASES[1],
               "wkv6": WKV_CASES[2]}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def kernel_modules() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    return {"flash_attention": fa_kernel, "lru_scan": lru_kernel,
            "wkv6": wkv_kernel}


def zero_launches() -> None:
    mods = kernel_modules()
    for mod in mods.values():
        mod.launches = 0
    mods["lru_scan"].tma_launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    return {name: mod.launches for name, mod in kernel_modules().items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call. A ~5 ms spin kernel is queued first, so the
    host enqueues the timed calls while the card is busy: a kernel shorter
    than its wrapper's Python overhead is timed on the device, not at the
    host's launch rate."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: int, n_ops: int, dtype) -> dict:
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def profile_window(label: str, fn, by_stream: bool = False):
    """Device busy share and the top kernels of one window, from
    torch.profiler's kernel events (times under the profiler).
    ``by_stream``: also each CUDA stream's kernel time, named by the
    profiler ranges its kernels were launched from, and the busy share
    as the union of kernel intervals (two streams overlap); returned."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        # the runtime's profiler ranges (hts.*) show on the device side
        # too; they are not kernels
        if e.device_type == DeviceType.CUDA and not e.name.startswith("hts."):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"profile {label}: wall {wall_us / 1e3:.3f} ms; device time "
              "not measured (the profiler recorded no kernels)")
        return stream_times(label, prof, wall_us) if by_stream else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, kernels "
          f"{busy_us / 1e3:.3f} ms (device busy {100 * busy_us / wall_us:.1f}"
          "%); top: " + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms"
                                  for n, t in top))
    ours = {k: sum(t for n, t in by_name.items() if k in n)
            for k in ("flash_fwd", "lru_scan", "wkv6")}
    print(f"profile {label}: the port's kernels " + ("; ".join(
        f"{k} {t / 1e3:.3f} ms ({100 * t / busy_us:.1f}%)"
        for k, t in ours.items() if t) or "none"))
    return stream_times(label, prof, wall_us) if by_stream else None


def stream_times(label: str, prof, wall_us: float) -> dict:
    """Each stream's kernel time from the profile's trace, named by the
    ``record_function`` range (``hts.learner``, ``hts.rollout``) that
    launched its kernels; the device busy share as the union of all
    kernel intervals over the wall time."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "dur" in e]
    if not kernels:
        print(f"profile {label}: by stream: not measured (no kernel events "
              "in the trace)")
        return {"busy_share": None, "streams": {}}
    launch_ts = {e["args"]["correlation"]: (e.get("tid"), e["ts"])
                 for e in events if e.get("cat") in ("cuda_runtime",
                                                     "cuda_driver")
                 and "correlation" in e.get("args", {})}
    ranges = [(e.get("tid"), e["ts"], e["ts"] + e["dur"], e["name"])
              for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("hts.")]

    def range_of(kernel):
        tid, ts = launch_ts.get(kernel["args"].get("correlation"),
                                (None, None))
        for rtid, a, b, name in ranges:
            if rtid == tid and a <= ts <= b:
                return name
        return "other"

    streams: dict = {}
    for k in kernels:
        row = streams.setdefault(k["args"].get("stream", "?"),
                                 {"kernel_ms": 0.0, "kernels": 0,
                                  "ranges": {}})
        row["kernel_ms"] += k["dur"] / 1e3
        row["kernels"] += 1
        name = range_of(k)
        row["ranges"][name] = row["ranges"].get(name, 0) + 1
    spans = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(r["kernel_ms"] for r in streams.values())
    print(f"profile {label}: device busy {100 * busy / wall_us:.1f}% "
          f"(union of kernel intervals {busy / 1e3:.3f} ms of wall "
          f"{wall_us / 1e3:.3f} ms; kernels summed over streams "
          f"{total:.3f} ms)")
    for sid, row in sorted(streams.items(), key=lambda kv: -kv[1]["kernel_ms"]):
        name = max(row["ranges"], key=row["ranges"].get)
        print(f"profile {label}: stream {sid} ({name}): {row['kernels']} "
              f"kernels, {row['kernel_ms']:.3f} ms")
    return {"busy_share": busy / wall_us, "union_ms": busy / 1e3,
            "wall_ms": wall_us / 1e3, "streams": {
                str(sid): {**row, "name": max(row["ranges"],
                                              key=row["ranges"].get)}
                for sid, row in streams.items()}}


# ------------------------------------------------------------ inputs
def flash_inputs(case, gen, fused: bool = False):
    """q, k, v ~ N(0, 1) in the model's layout; ``fused``: as strided
    views into one (B, S, H + 2 KV, Dh) tensor, as a fused projection
    would give them."""
    B, S, H, KV, Dh, *_, dt = case
    if fused:
        qkv = torch.randn((B, S, H + 2 * KV, Dh), generator=gen,
                          device="cuda").to(dt)
        return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    return [torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh))]


def lru_inputs(case, gen):
    """a = sigmoid(N(0,1)), b = N(0,1) in the case's dtype (a fifth entry,
    where there is one, is b's); h0 fp32."""
    B, S, D, dt, *b_dt = case
    a = torch.sigmoid(torch.randn((B, S, D), generator=gen, device="cuda"))
    b = torch.randn((B, S, D), generator=gen, device="cuda")
    h0 = torch.randn((B, D), generator=gen, device="cuda")
    return a.to(dt), b.to(b_dt[0] if b_dt else dt), h0


def shifted(t):
    """t's values in a contiguous view that starts one element into its
    buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def wkv_inputs(case, gen, decay: str = "reference"):
    """r, k, v = N(0,1) in the case's dtype; w in (0.49, 0.99), u and s0
    0.1 N(0,1), fp32 (the reference's test distribution). ``decay="fast"``:
    w uniform in (1e-4, 0.999) instead; ``"zero"``: that, with a tenth of
    the w exactly 0."""
    B, T, H, N, dt = case
    r, k, v = (torch.randn((B, T, H, N), generator=gen, device="cuda").to(dt)
               for _ in range(3))
    if decay in ("fast", "zero"):
        w = 1e-4 + (0.999 - 1e-4) * torch.rand((B, T, H, N), generator=gen,
                                               device="cuda")
        if decay == "zero":
            w[torch.rand(w.shape, generator=gen, device="cuda") < 0.1] = 0.0
    else:
        w = 0.5 * torch.sigmoid(torch.randn((B, T, H, N), generator=gen,
                                            device="cuda")) + 0.49
    u = 0.1 * torch.randn((H, N), generator=gen, device="cuda")
    s0 = 0.1 * torch.randn((B, H, N, N), generator=gen, device="cuda")
    return r, k, v, w, u, s0


# ------------------------------------------------------------ phases
def phase_card() -> str:
    check(torch.cuda.is_available(), "CUDA is not available")
    name = torch.cuda.get_device_name(0)
    print(f"card: {nvidia_smi()}")
    print(f"device: {name}; torch {torch.__version__}; "
          f"CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def phase_build() -> None:
    """One nvcc per source, all started together."""
    def build(item):
        name, mod = item
        t0 = time.perf_counter()
        lib = mod.library()
        return name, time.perf_counter() - t0, Path(lib._name)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build, kernel_modules().items()))
    print(f"build: {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f}s (in parallel)")
    for name, secs, path in built:
        print(f"build: {Path(SOURCES[name][0]).name} by nvcc for sm_90a in "
              f"{secs:.1f}s -> {path.name}")
        log = path.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
    for name, _, path in built:
        n = sass_count(path, "HGMMA|HMMA")
        print(f"sass: {path.name}: {n} tensor-core instructions "
              "(cuobjdump -sass | grep -cE 'HGMMA|HMMA')")
        if name in TENSOR_CORE_KERNELS:
            check(n > 0, f"{name}: no HGMMA/HMMA in its SASS")
        if name == "lru_scan":
            n = sass_count(path, "UTMALDG")
            print(f"sass: {path.name}: {n} TMA loads (cuobjdump -sass | "
                  "grep -c UTMALDG)")
            check(n > 0, "lru_scan: no UTMALDG in its SASS")


def sass_count(lib: Path, opcodes: str) -> int:
    """Lines of the library's SASS that hold one of ``opcodes`` (a regex
    alternation of whole instruction names)."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    return len(re.findall(rf"^.*\b({opcodes})\b.*$", sass, re.M))


def _report(name: str, cases: list) -> None:
    mods = kernel_modules()
    print(f"{name} vs plain version on the card: "
          + json.dumps({"name": name, "cases": cases,
                        "max_abs_err": max(c["max_abs_err"] for c in cases),
                        "launches": mods[name].launches}))


def _flash_cases(gen) -> float:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cases, main_err = [], 0.0
    for case in FLASH_CASES + [MAIN, RG_ATTN]:
        B, S, H, KV, Dh, causal, window, cap, bq, bk, dt = case
        q, k, v = flash_inputs(case, gen)
        kw = dict(causal=causal, window=window, cap=cap, bq=bq, bk=bk)
        out = fa_ops.attend(q, k, v, use_kernel=True, **kw)
        ref = fa_ops.attend(q, k, v, use_kernel=False, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = (out.shape == ref.shape and out.dtype == dt
              and bool(torch.isfinite(out).all()) and err <= TOL[dt])
        cases.append({"shape": [B, S, H, KV, Dh], "causal": causal,
                      "window": window, "cap": cap, "dtype": str(dt),
                      "max_abs_err": err, "tol": TOL[dt], "ok": ok})
        check(ok, f"flash_attention {cases[-1]}")
        if case in (MAIN, RG_ATTN):
            main_err = max(main_err, err)
    for case in FLASH_STRIDED:
        B, S, H, KV, Dh, causal, window, cap, bq, bk, dt = case
        q, k, v = flash_inputs(case, gen, fused=True)
        check(not q.is_contiguous(), "strided case: q is a strided view")
        kw = dict(causal=causal, window=window, cap=cap)
        out = fa_ops.attend(q, k, v, use_kernel=True, **kw)
        ref = fa_ops.attend(q, k, v, use_kernel=False, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = (out.shape == ref.shape and out.dtype == dt
              and bool(torch.isfinite(out).all()) and err <= TOL[dt])
        cases.append({"shape": [B, S, H, KV, Dh], "causal": causal,
                      "window": window, "cap": cap, "dtype": str(dt),
                      "layout": "strided views of fused qkv",
                      "max_abs_err": err, "tol": TOL[dt], "ok": ok})
        check(ok, f"flash_attention {cases[-1]}")
    # a bf16 head dim the tensor-core kernel has no form for is refused
    q, k, v = flash_inputs((1, 64, 2, 1, 48, True, 0, 0.0, 0, 0,
                            torch.bfloat16), gen)
    try:
        fa_ops.attend(q, k, v, use_kernel=True)
        check(False, "flash_attention took a bf16 head dim of 48")
    except ValueError as e:
        print(f"flash_attention, bf16 Dh=48 refused: {e}")
    _report("flash_attention", cases)
    return main_err


def _scan_case(name, shape, dt, out, ref, with_init) -> dict:
    """Both outputs of a scan kernel against its plain version: allclose
    at SCAN_TOL (atol and rtol, as tests/test_kernels.py), finite, same
    shape and dtype."""
    tol = SCAN_TOL[dt]
    err, ok = 0.0, True
    for o, r in zip(out, ref):
        err = max(err, (o.float() - r.float()).abs().max().item())
        ok = ok and (o.shape == r.shape and o.dtype == r.dtype
                     and bool(torch.isfinite(o).all())
                     and torch.allclose(o.float(), r.float(), atol=tol,
                                        rtol=tol))
    case = {"shape": list(shape), "dtype": str(dt), "init": with_init,
            "max_abs_err": err, "tol": tol, "ok": ok}
    check(ok, f"{name} {case}")
    return case


def _lru_cases(gen) -> float:
    """Every case through ``ops.scan`` (the route ``kernel.use_tma``
    picks) and the main shape on both kernels, forced; each held against
    the plain version at SCAN_TOL and bit for bit, with and without h0."""
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.kernels.lru_scan import ops as lru_ops
    cases, main_err = [], 0.0
    runs = [(case, None, "") for case in
            LRU_CASES + list(LRU_ROUTES) + LRU_MIXED]
    runs += [(LRU_SHIFTED, None, shift) for shift in LRU_SHIFTS]
    runs += [(LRU_MAIN, "per-thread", "")]
    for case, force, shift in runs:
        a, b, h0 = lru_inputs(case, gen)
        if "a" in shift:
            a = shifted(a)
        if "b" in shift:
            b = shifted(b)
        route = force or ("tma" if lru_kernel.use_tma(
            a.dtype, b.dtype, a.shape[2], a.data_ptr(), b.data_ptr())
            else "per-thread")
        if case in LRU_ROUTES and force is None:
            check(route == LRU_ROUTES[case],
                  f"lru_scan {case} took {route}, not {LRU_ROUTES[case]}")
        if shift:
            check(route == "per-thread",
                  f"lru_scan {case} with {shift} shifted took {route}")
        for init in (h0, None):
            before = lru_kernel.tma_launches
            if force is None:
                out = lru_ops.scan(a, b, init, use_kernel=True)
            else:
                out = lru_kernel.lru_scan(a, b, init, tma=force == "tma")
            ref = lru_ops.scan(a, b, init, use_kernel=False)
            torch.cuda.synchronize()
            check(lru_kernel.tma_launches - before == (route == "tma"),
                  f"lru_scan {case}: the launch did not take {route}")
            row = _scan_case("lru_scan", case[:3], case[3], out, ref,
                             init is not None)
            row.update(b_dtype=str(b.dtype), route=route,
                       bit_equal=all(torch.equal(o, r)
                                     for o, r in zip(out, ref)))
            if shift:
                row["shifted"] = shift
            cases.append(row)
            print(f"lru_scan {list(case[:3])} a {a.dtype} b {b.dtype} "
                  f"h0 {init is not None}"
                  + (f" ({shift} one element into its buffer)" if shift
                     else "")
                  + f": route {route}, bit-equal to the plain version "
                  f"{row['bit_equal']}")
            check(row["bit_equal"], f"lru_scan not bit-equal: {row}")
            check(out[0].dtype == a.dtype and out[1].dtype == torch.float32
                  and torch.equal(out[1], out[0][:, -1].float()),
                  f"lru_scan h_last is y[:, -1] widened, {case}")
            if case == LRU_MAIN:
                main_err = max(main_err, row["max_abs_err"])
    _report("lru_scan", cases)
    return main_err


def _wkv_cases(gen) -> float:
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
    cases = []
    for case in WKV_CASES + [WKV_MAIN, WKV_DECODE]:
        r, k, v, w, u, s0 = wkv_inputs(case, gen)
        for init in (s0, None):
            out = wkv_ops.mix(r, k, v, w, u, init, use_kernel=True)
            ref = wkv_ops.mix(r, k, v, w, u, init, use_kernel=False)
            torch.cuda.synchronize()
            cases.append(_scan_case("wkv6", case[:4], case[4], out, ref,
                                    init is not None))
    main_err = max(c["max_abs_err"] for c in cases[-4:])
    r, k, v, w, u, s0 = wkv_inputs(WKV_MAIN32, gen)
    out = wkv_ops.mix(r, k, v, w, u, s0, use_kernel=True)
    ref = wkv_ops.mix(r, k, v, w, u, s0, use_kernel=False)
    torch.cuda.synchronize()
    cases.append(_rel_case(WKV_MAIN32, out, ref))
    for case in WKV_EDGE:
        for decay in ("reference", "fast", "zero"):
            r, k, v, w, u, s0 = wkv_inputs(case, gen, decay)
            out = wkv_ops.mix(r, k, v, w, u, s0, use_kernel=True)
            ref = wkv_ops.mix(r, k, v, w, u, s0, use_kernel=False)
            torch.cuda.synchronize()
            if case[4] == torch.float32:
                cases.append(_rel_case(case, out, ref, decay=decay))
            else:
                cases.append(_scan_case("wkv6", case[:4], case[4], out, ref,
                                        True))
                cases[-1]["decay"] = decay
    # the chunked kernel against the same math in plain PyTorch, at the
    # prefill shape: a fault here is in the kernel, not in the chunked form
    for case in (WKV_MAIN, WKV_MAIN32):
        r, k, v, w, u, s0 = wkv_inputs(case, gen)
        out = wkv_ops.mix(r, k, v, w, u, s0, use_kernel=True)
        ref = wkv6_chunked_ref(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        if case[4] == torch.float32:
            cases.append(_rel_case(case, out, ref, against="wkv6_chunked_ref"))
        else:
            cases.append(_scan_case("wkv6", case[:4], case[4], out, ref,
                                    True))
            cases[-1]["against"] = "wkv6_chunked_ref"
    _report("wkv6", cases)
    return main_err


def _rel_case(case, out, ref, **extra) -> dict:
    """fp32 wkv6 outputs held at WKV_REL_TOL of the reference's largest
    value (see WKV_REL_TOL), finite."""
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    err = max((o - x).abs().max().item() for o, x in zip(out, ref))
    rel = max(((o - x).abs().max() / x.abs().max()).item()
              for o, x in zip(out, ref))
    row = {"shape": list(case[:4]), "dtype": str(case[4]), "init": True,
           "chunked": wkv_kernel.chunked(case[1], case[3]),
           "max_abs_err": err, "rel_max_err": rel, "rel_tol": WKV_REL_TOL,
           **extra,
           "ok": rel <= WKV_REL_TOL
           and all(bool(torch.isfinite(o).all()) for o in out)}
    check(row["ok"], f"wkv6 {row}")
    return row


def phase_kernels() -> dict:
    """Every case: kernel vs plain version on the card. Returns each
    kernel's largest error at the main paths' shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {"flash_attention": _flash_cases(gen), "lru_scan": _lru_cases(gen),
            "wkv6": _wkv_cases(gen)}


def _expect(counts: dict, expected: dict, what: str) -> None:
    want = {name: expected.get(name, 0) for name in SOURCES}
    check(counts == want, f"{what}: launches {counts}, expected {want}")


def phase_serve(arch: str) -> dict:
    """One main path at full width; returns its launch counts and
    steady-state times."""
    from repro_torch.launch import serve
    from repro_torch.models import backbone

    main_expect, prefill_expect, step_expect = SERVE_PATHS[arch]
    argv = ["--arch", arch, "--batch", str(BATCH), "--prompt-len",
            str(PROMPT), "--gen", str(GEN)]
    zero_launches()
    res = serve.main(argv)
    launches = read_launches()
    # every lru_scan launch of the run took the TMA kernel
    lru_tma = kernel_modules()["lru_scan"].tma_launches
    check(lru_tma == launches["lru_scan"],
          f"{arch}: {lru_tma} of {launches['lru_scan']} lru_scan launches "
          "took the TMA kernel")
    cfg = res.cfg
    B, S = res.prompts.shape
    print(f"main path: {cfg.name} n_layers={cfg.n_layers} "
          f"d_model={cfg.d_model} dtype={cfg.dtype}; launches in prefill + "
          f"{GEN - 1} decode steps {launches} (lru_scan on the TMA kernel: "
          f"{lru_tma})")
    _expect(launches, main_expect, f"{arch} serve.main")
    check(res.prefill_logits.shape == (B, cfg.vocab_size)
          and bool(torch.isfinite(res.prefill_logits).all()),
          "prefill logits finite and (B, vocab)")
    check(res.tokens.shape == (B, GEN) and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size, "generated tokens")

    with torch.inference_mode():
        zero_launches()
        _, _, cache = backbone.prefill(res.model, cfg, res.prompts, S + GEN)
        per_prefill = read_launches()
        zero_launches()
        backbone.decode_step(res.model, cfg, res.tokens[:, :1], cache, S)
        per_step = read_launches()
    print(f"{arch}: launches per prefill {per_prefill}, per decode step "
          f"{per_step}")
    _expect(per_prefill, prefill_expect, f"{arch} prefill")
    _expect(per_step, step_expect, f"{arch} decode step")

    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    zero_launches()
    with torch.inference_mode():
        plain_logits, _, _ = backbone.prefill(res.model, plain_cfg,
                                              res.prompts, S + GEN)
    _expect(read_launches(), {}, f"{arch} plain-version prefill")
    rel = ((res.prefill_logits - plain_logits).abs().max()
           / plain_logits.abs().max()).item()
    print(f"{arch} prefill logits, kernels vs plain versions (same weights):"
          f" relative max error {rel:.3e} (bound 5e-2)")
    check(rel < 5e-2, f"{arch} prefill logits vs plain versions")
    if arch == "rwkv6-7b":
        wkv_order_witness(res.model, plain_cfg, res.prompts, plain_logits)

    prefill_ms, tok_s = [], []
    for _ in range(3):
        _, _, p_s, d_s = serve.generate(res.model, cfg, res.prompts, GEN)
        prefill_ms.append(p_s * 1e3)
        tok_s.append(B * (GEN - 1) / d_s)
    with torch.inference_mode():
        profile_window(f"{arch} prefill", lambda: backbone.prefill(
            res.model, cfg, res.prompts, S + GEN))
        _, _, cache = backbone.prefill(res.model, cfg, res.prompts, S + GEN)
        tok = res.tokens[:, :1]
        profile_window(f"{arch} decode, 8 steps", lambda: [
            backbone.decode_step(res.model, cfg, tok, cache, S + i)
            for i in range(8)])
    del res, plain_logits, cache
    torch.cuda.empty_cache()

    tokens = []
    for _ in range(2):
        run = serve.main(argv + ["--temperature", "1.0", "--seed", "3"])
        tokens.append(run.tokens.clone())
        del run
        torch.cuda.empty_cache()
    check(torch.equal(*tokens), f"{arch} sampled rerun gave other tokens")
    print(f"{arch} sampled rerun (temperature 1.0, seed 3): identical tokens")

    fp32_cfg = dataclasses.replace(cfg, dtype="float32")
    big, prompts = serve.build(fp32_cfg, BATCH, PROMPT, torch.device("cuda"))
    with torch.inference_mode():
        k_logits, _, _ = backbone.prefill(big, fp32_cfg, prompts, S + GEN)
        p_logits, _, _ = backbone.prefill(
            big, dataclasses.replace(fp32_cfg, use_pallas_attention=False),
            prompts, S + GEN)
    rel32 = ((k_logits - p_logits).abs().max()
             / p_logits.abs().max()).item()
    print(f"{arch} full width in fp32, kernels vs plain versions (same "
          f"weights): prefill logits relative max error {rel32:.3e} "
          "(bound 1e-3)")
    check(rel32 < 1e-3, f"{arch} fp32 prefill logits vs plain versions")
    del big, k_logits, p_logits
    torch.cuda.empty_cache()

    small_cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    small, prompts = serve.build(small_cfg, 2, 150, torch.device("cuda"))
    g_logits, g_tokens, _, _ = serve.generate(small, small_cfg, prompts, 6)
    c_logits, c_tokens, _, _ = serve.generate(small.to("cpu"), small_cfg,
                                              prompts.cpu(), 6)
    err = (g_logits.cpu() - c_logits).abs().max().item()
    same = torch.equal(g_tokens.cpu(), c_tokens)
    print(f"{arch} reduced fp32 ({small_cfg.n_layers} layers, prompt 150): "
          f"card vs CPU prefill logits max abs err {err:.3e} (tol 1e-4); "
          f"greedy tokens equal {same}")
    check(err < 1e-4 and same, f"{arch} reduced model: card vs CPU")
    del small
    torch.cuda.empty_cache()
    return {"launches": launches, "lru_scan_tma": lru_tma,
            "prefill_ms": prefill_ms, "tok_s": tok_s}


def wkv6_reordered(r, k, v, w, u, s0=None):
    """The plain wkv6 with o summed in another order: r_t S_{t-1}, then
    the bonus as v_j * sum_i r_i u_i k_i. The same function as
    ``wkv6_ref``; only fp32 rounding before o's cast to bf16 differs."""
    B, T, H, N = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    s = (torch.zeros((B, H, N, N), device=r.device) if s0 is None
         else s0.float())
    o = torch.empty((B, T, H, N), device=r.device)
    for t in range(T):
        bonus = (rf[:, t] * u * kf[:, t]).sum(-1, keepdim=True)
        o[:, t] = torch.einsum("bhn,bhnm->bhm", rf[:, t], s) \
            + bonus * vf[:, t]
        s = wf[:, t, :, :, None] * s + kf[:, t, :, :, None] \
            * vf[:, t, :, None, :]
    return o.to(r.dtype), s


def wkv_order_witness(model, plain_cfg, prompts, plain_logits) -> None:
    """How far a change of wkv6's summation order alone moves RWKV-6's
    bf16 prefill logits: the plain run against the plain run with
    ``wkv6_reordered``. The kernel's own distance from the plain run is
    read against this."""
    from unittest import mock

    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.models import backbone

    def mix(r, k, v, w, u, s0=None, *, use_kernel=True):
        return wkv6_reordered(r, k, v, w, u, s0)

    with mock.patch.object(wkv_ops, "mix", mix), torch.inference_mode():
        re_logits, _, _ = backbone.prefill(model, plain_cfg, prompts,
                                           prompts.shape[1] + GEN)
    rel = ((re_logits - plain_logits).abs().max()
           / plain_logits.abs().max()).item()
    print(f"rwkv6-7b prefill logits, plain vs plain with wkv6's sum "
          f"reordered (same weights): relative max error {rel:.3e}")


# ------------------------------------------------------------ kernel times
def flash_times(case) -> dict:
    """The kernel at a main path's shape, called as the serving path calls
    it (the model's layout, S unpadded), against its bound, the plain
    version and SDPA (both on (B, H, S, Dh) copies, their layout)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, Sq, H, KV, Dh, causal, window, *_, dt = case
    q, k, v = flash_inputs(case, torch.Generator(device="cuda").manual_seed(1))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = dict(causal=causal, window=window, cap=0.0)
    ms = cuda_ms(lambda: fa_kernel.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_ref(qt, kt, vt, **kw))
    # SDPA computes the same function only where the window masks nothing
    library_ms = None
    if not window or window >= Sq:
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)

            def lib_call():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
        except TypeError:  # torch without enable_gqa: expand kv heads first
            kx, vx = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))

            def lib_call():
                return F.scaled_dot_product_attention(qt, kx, vx,
                                                      is_causal=True)
        library_ms = cuda_ms(lib_call)

    # the work this call's masks leave: (query, key) pairs causal and
    # inside the window
    qpos = torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Sq, device="cuda")[None, :]
    keep = kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    pairs = int(keep.sum())
    # bytes: q, k, v read and o written once
    b = bound(nbytes(q, k, v, q), 4 * B * H * pairs * Dh, dt)
    print(f"  flash_attention (B={B} H={H} KV={KV} S={Sq} Dh={Dh} "
          f"window={window} {dt} causal, model layout): kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}; "
          f"bound {b['bound_ms']:.4f} ms ({b['bytes']} bytes, {b['ops']} "
          "FLOP)")
    return {"shape": [B, Sq, H, KV, Dh], "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **b}


def lru_times() -> list:
    """Both kernels at the main shape, forced through the binding's
    ``tma`` argument and timed in turns (per-thread, TMA, TMA,
    per-thread); each one's time is the mean of its two reads. The TMA
    kernel's row first (the route the main path takes), the per-thread
    one's second."""
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.kernels.lru_scan.ref import lru_scan_ref
    B, S, D, dt = LRU_MAIN
    a, b, h0 = lru_inputs(LRU_MAIN,
                          torch.Generator(device="cuda").manual_seed(1))
    reads = {"tma": [], "per-thread": []}
    for route in ("per-thread", "tma", "tma", "per-thread"):
        reads[route].append(cuda_ms(lambda: lru_kernel.lru_scan(
            a, b, h0, tma=route == "tma")))
    plain_ms = cuda_ms(lambda: lru_scan_ref(a, b, h0), iters=5, warmup=1)
    # a yardstick of the rate this traffic gets, not the same function: an
    # elementwise product that reads a and b and writes y
    y = torch.empty_like(a)
    mul_ms = cuda_ms(lambda: torch.mul(a, b, out=y))
    # a, b in; y out (a's size); h0 in, h_last out; 2 FLOP per element
    bd = bound(nbytes(a, b, a, h0, h0), 2 * B * S * D, torch.float32)
    print(f"  torch.mul(a, b, out=y) at (B={B} S={S} D={D}) {dt}, the same "
          f"traffic but h0 and h_last: {mul_ms:.4f} ms, "
          f"{nbytes(a, b, a) / (mul_ms * 1e-3) / 1e9:.1f} GB/s")
    rows = []
    for route in ("tma", "per-thread"):
        ms = sum(reads[route]) / 2
        gb_s = bd["bytes"] / (ms * 1e-3) / 1e9
        print(f"  lru_scan (B={B} S={S} D={D} {dt}, h0), {route} kernel: "
              f"{ms:.4f} ms (reads " + ", ".join(
                  f"{x:.4f}" for x in reads[route]) + f"), {gb_s:.1f} GB/s "
              f"= {100 * gb_s * 1e9 / HBM_BYTES_S:.1f}% of 3.35 TB/s; plain "
              f"{plain_ms:.4f} ms, library n/a (no single PyTorch call "
              f"computes a linear recurrence); bound {bd['bound_ms']:.4f} ms "
              f"({bd['bytes']} bytes, {bd['ops']} FLOP)")
        rows.append({"shape": [B, S, D], "kernel": route, "ms": ms,
                     "reads_ms": reads[route], "gb_s": gb_s,
                     "same_traffic_mul_ms": mul_ms,
                     "plain_ms": plain_ms, "library_ms": None, **bd})
    return rows


def wkv_times(case) -> dict:
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    B, T, H, N, dt = case
    gen = torch.Generator(device="cuda").manual_seed(1)
    r, k, v, w, u, s0 = wkv_inputs(case, gen)
    ms = cuda_ms(lambda: wkv_kernel.wkv6(r, k, v, w, u, s0))
    plain_ms = cuda_ms(lambda: wkv6_ref(r, k, v, w, u, s0),
                       iters=5 if T > 1 else 20, warmup=1 if T > 1 else 3)
    # r, k, v, w, u, s0 in; o (r's size) and s_T (s0's size) out. Least
    # FLOP per (b, h, t): r S (2 N^2), the bonus v_j sum_i r_i u_i k_i
    # (3 N + 2 N) and S <- w S + k^T v (3 N^2): 5 N^2 + 5 N
    # The operations at the rate of the units that do them: TF32 tensor
    # cores for the chunked kernel, the CUDA cores for the recurrent one;
    # the CUDA-core reading is printed beside it either way.
    n_bytes, n_ops = (nbytes(r, k, v, w, u, s0, r, s0),
                      B * H * T * (5 * N * N + 5 * N))
    chunked = wkv_kernel.chunked(T, N)
    bd = bound(n_bytes, n_ops, "tf32" if chunked else torch.float32)
    cuda_cores = bound(n_bytes, n_ops, torch.float32)
    print(f"  wkv6 (B={B} T={T} H={H} N={N} {dt}, w fp32, s0; "
          f"{'chunked, tensor cores' if chunked else 'recurrent'}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library n/a (no single "
          f"PyTorch call computes the WKV recurrence); bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} ({bd['bytes']} bytes,"
          f" {bd['ops']} FLOP; {cuda_cores['bound_ms']:.4f} ms at the CUDA "
          "cores' 67 TFLOP/s fp32)")
    return {"shape": [B, T, H, N], "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "chunked": chunked,
            "bound_ms_cuda_cores": cuda_cores["bound_ms"], **bd}


def _entry(name: str, runs: dict, err: float, times: list) -> dict:
    by_path = {arch: run["launches"][name] for arch, run in runs.items()
               if run["launches"][name]}
    first = times[0]
    extra = {}
    if name == "lru_scan":
        extra["launches_tma"] = sum(run["lru_scan_tma"] for run in runs.values())
        extra.update({k: first[k] for k in ("kernel", "reads_ms", "gb_s",
                                            "same_traffic_mul_ms")})
    return {"name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **extra,
            "max_abs_err": err,
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
            "shape": first["shape"], "other_shapes": times[1:]}


# ------------------------------------------------------------ training
def build_session(spec, device: str, **hts):
    """``api.build(spec, device=device)``, the user's path, for an
    ``ExperimentSpec`` or its dict; ``hts`` overrides the spec's ``hts``
    block. Params come from ``params_seed`` on the CPU, so a card and a
    CPU session of one spec start from the same params."""
    from repro_torch import api
    if isinstance(spec, dict):
        spec = api.from_dict(spec)
    if hts:
        spec = spec.replace(hts={**spec.hts, **hts})
    return api.build(spec, device=device)


def golden_spec(algorithm: str) -> dict:
    """tests/test_goldens.py's configuration as a spec."""
    return {"algorithm": algorithm, "env": {"name": "catch"},
            "policy": {"name": "mlp"}, "runtime": {"name": "mesh"},
            "optimizer": {"name": "rmsprop",
                          "kwargs": {"lr": 7e-4, "eps": 1e-5}},
            "hts": dict(GOLDEN), "params_seed": 0}


def _same_streams(a, b) -> bool:
    return (a.rewards.shape == b.rewards.shape
            and bool((a.rewards == b.rewards).all())
            and bool((a.dones == b.dones).all()))


def _params_equal(a, b) -> bool:
    return all(torch.equal(a[k].cpu(), b[k].cpu()) for k in a)


def _params_diff(a, b) -> float:
    return max((a[k].cpu() - b[k].cpu()).abs().max().item() for k in a)


def _train_golden() -> dict:
    rows = {}
    for alg in TRAIN_ALGORITHMS:
        spec = golden_spec(alg)
        card = build_session(spec, "cuda").run(GOLDEN_INTERVALS)
        cpu = build_session(spec, "cpu").run(GOLDEN_INTERVALS)
        same = _same_streams(card, cpu)
        diff = _params_diff(card.params, cpu.params)
        steps = (int(card.state.step), int(cpu.state.step))
        print(f"train goldens {alg} (catch, mlp, rmsprop, alpha 4, n_envs 4, "
              f"seed 3, {GOLDEN_INTERVALS} intervals, K=1): card vs CPU "
              f"reward/done streams equal {same}; params max abs diff "
              f"{diff:.3e} (tol {PARAMS_TOL}); step {steps}")
        check(same, f"train goldens {alg}: card streams differ from the CPU's")
        check(diff <= PARAMS_TOL, f"train goldens {alg}: params {diff}")
        check(steps == (GOLDEN_INTERVALS,) * 2, f"train goldens {alg}: step")
        rows[alg] = {"streams_equal": same, "params_max_abs_diff": diff}
    return rows


def _train_quickstart(smi: str) -> dict:
    from repro_torch import api
    from repro_torch.core import mesh_runtime
    spec = api.load(str(QUICKSTART))
    n = spec.intervals
    print(f"train quickstart ({QUICKSTART.relative_to(ROOT)}): env "
          f"{spec.env.name}, policy {spec.policy.name}, {spec.algorithm}, "
          f"{spec.optimizer.name} {spec.optimizer.kwargs}, runtime "
          f"{spec.runtime.name}, hts {spec.hts}, {n} intervals")
    runs = [build_session(spec, "cuda").run(n),
            build_session(spec, "cuda").run(n)]
    rerun_same = (_params_equal(runs[0].params, runs[1].params)
                  and _same_streams(*runs)
                  and int(runs[0].state.step) == int(runs[1].state.step))
    print(f"train quickstart: two runs on the card bit-identical (params and "
          f"streams) {rerun_same}")
    check(rerun_same, "train quickstart: a rerun on the card differs")
    dev = build_session(spec, "cuda", env_backend="device").run(n)
    backends_same = _same_streams(runs[0], dev)
    print(f"train quickstart: host and device env backends give equal streams"
          f" {backends_same}; equal params "
          f"{_params_equal(runs[0].params, dev.params)}")
    check(backends_same, "train quickstart: env backends differ")
    k2 = build_session(spec, "cuda", staleness=2).run(n)
    print(f"train quickstart K=2: step {int(k2.state.step)}")
    check(int(k2.state.step) == n, "train quickstart K=2: step != intervals")
    for r in runs + [dev, k2]:
        check(bool(torch.isfinite(torch.cat([p.flatten() for p in
                                              r.params.values()])).all()),
              "train quickstart: params not finite")
    ret = mesh_runtime.episode_returns({"rewards": runs[0].rewards.copy(),
                                        "dones": runs[0].dones.copy()})
    done = ~torch.isnan(ret)
    half = ret.shape[0] // 2
    means = [ret[:half][done[:half]].mean().item(),
             ret[half:][done[half:]].mean().item()]
    print(f"train quickstart: mean episode return, first / second half of "
          f"the run: {means[0]:.3f} / {means[1]:.3f}")
    sps = {"host": [r.sps for r in runs], "device": dev.sps, "K=2": k2.sps}
    print(f"train quickstart times on {smi}: env steps/s (alpha "
          f"{spec.hts['alpha']} x {spec.hts['n_envs']} envs x {n} "
          "intervals, host clock to the last synchronize): host backend "
          + ", ".join(f"{x:.1f}" for x in sps["host"])
          + f" (the first with the card's warm-up); device backend "
          f"{dev.sps:.1f}; K=2 (host backend) {k2.sps:.1f}")
    return {"rerun_bit_identical": rerun_same, "backends_equal": backends_same,
            "sps": sps, "episode_return_halves": means}


def _timed_runs(rt, n: int, what: str) -> list:
    """A warm-up run (excluded), then 3 runs of ``n`` intervals, each
    applying n updates and all giving the same streams."""
    rt.run(n)
    runs = [rt.run(n) for _ in range(3)]
    check(all(int(r.state.step) == n for r in runs), f"{what}: step")
    check(all(_same_streams(runs[0], r) for r in runs[1:]),
          f"{what}: reruns differ")
    return runs


def _train_scale(smi: str) -> dict:
    from repro_torch import api
    n = SCALE["intervals"]
    rt = build_session(api.load(str(QUICKSTART)), "cuda",
                       env_backend="device", alpha=SCALE["alpha"],
                       n_envs=SCALE["n_envs"]).runtime
    runs = _timed_runs(rt, n, "train scale")
    sps = [r.sps for r in runs]
    print(f"train scale times on {smi}: device backend, mlp, alpha "
          f"{SCALE['alpha']} x {SCALE['n_envs']} envs x {n} intervals "
          f"({n * SCALE['alpha'] * SCALE['n_envs']} env steps a run): env "
          "steps/s (3 runs after a warm-up run) "
          + ", ".join(f"{x:.1f}" for x in sps) + "; ms per interval "
          + ", ".join(f"{1e3 * r.wall_time / n:.2f}" for r in runs))
    prof = profile_window(f"train n_envs {SCALE['n_envs']}, {n} intervals",
                          lambda: rt.run(n), by_stream=True)
    return {"sps": sps, "ms_per_interval": [1e3 * r.wall_time / n
                                            for r in runs], "profile": prof}


def _rel(a, b) -> float:
    b = b.cpu().float()
    return ((a.cpu().float() - b).abs().max() / b.abs().max()).item()


def _train_cnn(smi: str) -> dict:
    """The paper CNN at its published widths on a synthetic trajectory:
    one actor_forward and one learner pass on the card against the
    port's CPU (fp32, TF32 off), and their times."""
    from repro_torch import models, optim
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.core import (delayed_grad, determinism, engine,
                                  mesh_runtime, rollout)
    from repro_torch.core.tree import tree_map
    from repro_torch.envs.interfaces import Env
    A, N = CNN_TRAJ["alpha"], CNN_TRAJ["n_envs"]
    env = Env("paper-cnn", None, None, CONFIG.obs_shape, CONFIG.n_actions)
    pol = models.get_policy("cnn", env)
    params = pol.init(determinism.master_key(0))
    gen = torch.Generator().manual_seed(0)
    traj = {
        "obs": torch.rand((A, N) + CONFIG.obs_shape, generator=gen),
        "actions": torch.randint(0, CONFIG.n_actions, (A, N), generator=gen,
                                 dtype=torch.int32),
        "rewards": torch.randn((A, N), generator=gen),
        "dones": (torch.rand((A, N), generator=gen) < 0.1).float(),
        "behavior_logprob": torch.log(0.02 + 0.1 * torch.rand(
            (A, N), generator=gen)),
        "bootstrap_obs": torch.rand((N,) + CONFIG.obs_shape, generator=gen),
    }
    cfg = engine.HTSConfig(alpha=A, n_envs=N)
    opt = optim.rmsprop(7e-4, eps=1e-5)
    grad_fn = mesh_runtime.make_grad_fn(pol.apply, cfg)
    learn = mesh_runtime.make_learner_update(pol.apply, opt, cfg)
    keys = determinism.obs_keys(determinism.master_key(0), torch.arange(N), 0)
    out, times = {}, {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), params)
        t = tree_map(lambda x: x.to(dev), traj)
        k = keys.to(dev)
        dg = delayed_grad.init(p, opt)
        with engine.deterministic_cudnn():
            out[dev] = (rollout.actor_forward(pol.apply, p, t["obs"][0], k),
                        grad_fn(p, t), learn(dg, t))
            if dev == "cuda":
                times["actor_forward_ms"] = cuda_ms(
                    lambda: rollout.actor_forward(pol.apply, p, t["obs"][0],
                                                  k))
                times["learner_pass_ms"] = cuda_ms(lambda: learn(dg, t),
                                                   iters=5, warmup=1)
    (ca, cb), cg, cdg = out["cpu"]
    (ga, gb), gg, gdg = out["cuda"]
    # behavior logprobs, each gradient leaf and each rmsprop state leaf
    # relative to its own largest magnitude; the updated params relative to
    # the params tree's largest magnitude: rmsprop's first step,
    # -lr g / (|g| / 10 + eps), moves an entry by up to lr / eps = 70 times
    # its gradient's rounding where |g| is near 0, so a leaf of small
    # weights (fc_w) carries that amplified rounding beside its own scale
    # (printed per leaf)
    p_scale = max(cdg.params[k].abs().max().item() for k in cdg.params)
    p_diff = {k: (gdg.params[k].cpu() - cdg.params[k]).abs().max().item()
              for k in cdg.params}
    errs = {"behavior_logprob": _rel(gb, cb),
            "grads": max(_rel(gg[k], cg[k]) for k in cg),
            "params": max(p_diff.values()) / p_scale,
            "opt_state": max(_rel(gdg.opt_state["sq"][k],
                                  cdg.opt_state["sq"][k]) for k in cg)}
    print("train paper CNN: card vs CPU, updated params max abs diff by "
          "leaf (relative to the leaf's largest value): " + "; ".join(
              f"{k} {d:.2e} ({_rel(gdg.params[k], cdg.params[k]):.2e})"
              for k, d in p_diff.items()))
    same_actions = torch.equal(ga.cpu(), ca)
    print(f"train paper CNN {CONFIG.obs_shape}, convs {CONFIG.conv_filters} "
          f"x {CONFIG.conv_sizes} / {CONFIG.conv_strides}, fc "
          f"{CONFIG.hidden}, {CONFIG.n_actions} actions; trajectory alpha {A}"
          f" x {N} envs: card vs CPU (fp32, TF32 off) actions equal "
          f"{same_actions}; relative max errors {json.dumps(errs)} (tol "
          f"{CNN_REL_TOL})")
    check(same_actions, "train paper CNN: actions differ, card vs CPU")
    check(max(errs.values()) <= CNN_REL_TOL,
          f"train paper CNN: card vs CPU {errs}")
    print(f"train paper CNN times on {smi}: actor_forward (16 obs) "
          f"{times['actor_forward_ms']:.3f} ms, learner pass (per-env "
          f"vmap(grad) over {N} envs, tree sum, rmsprop) "
          f"{times['learner_pass_ms']:.3f} ms")
    return {"errors": errs, **times}


def phase_train() -> dict:
    """The RL training interval on the card (phase 6 of the docstring).
    The kernel launch counts are zeroed before and read after: the path
    launches none of the port's kernels."""
    import warnings
    smi = nvidia_smi()
    zero_launches()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = {"golden": _train_golden(),
                   "quickstart": _train_quickstart(smi)}
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).splitlines()[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
    print("train: ops without a deterministic implementation, used in the "
          "goldens and quickstart runs: " + ("; ".join(flagged) or "none"))
    res["scale"] = _train_scale(smi)
    res["cnn"] = _train_cnn(smi)
    launches = read_launches()
    print(f"train: launches of the port's kernels on the training path "
          f"{launches}")
    _expect(launches, {}, "training path")
    res["nondeterministic_ops"] = flagged
    print("train: " + json.dumps(res))
    return res


# --------------------------------------------------------- entry point
def _launcher(args: list, what: str) -> str:
    """``python -m repro_torch.launch.run ARGS`` from the checkout, as a
    user runs it; its output printed, a non-zero exit a failure."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    print(f"run: {what}: python -m repro_torch.launch.run "
          f"{' '.join(args)} -> exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f}s")
    for line in proc.stdout.splitlines():
        print(f"  | {line}")
    check(proc.returncode == 0,
          f"launcher ({what}) exited {proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout


def _capsules_equal(a, b) -> bool:
    from repro_torch.core.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.cpu(), y.cpu()) for x, y in zip(la, lb))


def _fail_segment_once(session, at: int):
    """The segment that starts at interval ``at`` raises once, as a
    learner death would (the fused runtime has no fault site of its
    own; the trainer's supervision is what is checked)."""
    from repro_torch.faults import FaultEvent, InjectedFault
    rt = session.runtime
    real = rt.run_from
    left = [1]

    def run_from(state, n, finalize=True):
        if int(state.interval) == at and left[0]:
            left[0] -= 1
            raise InjectedFault(FaultEvent("learner", at))
        return real(state, n, finalize)

    rt.run_from = run_from
    return session


def _run_launcher(tmp: Path) -> dict:
    """(a): the launcher as typed, then stopped and resumed, against an
    uninterrupted ``Session.fit`` on the card."""
    from repro_torch import api
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import trainer
    quick = str(QUICKSTART.relative_to(ROOT))
    _launcher(["--spec", quick], "the quickstart spec, no other flag")
    ck = tmp / "launcher"
    common = ["--spec", quick, "--ckpt-dir", str(ck), "--ckpt-every",
              str(RUN_EVERY)]
    _launcher(common + ["--intervals", str(RUN_STOP)],
              f"checkpointed, stopped at {RUN_STOP}")
    out = _launcher(common + ["--intervals", str(RUN_TOTAL), "--resume"],
                    f"resumed to {RUN_TOTAL}")
    check(f"{RUN_TOTAL} intervals ({RUN_STOP} resumed)" in out,
          "launcher: the resumed run did not report its resume")
    spec = api.load(str(QUICKSTART)).replace(
        checkpoint={"dir": str(tmp / "straight"), "every": RUN_EVERY})
    straight = api.build(spec, device="cuda").fit(RUN_TOTAL)
    path = ckpt_io.latest(str(ck))
    check(path is not None and path.endswith(f"step_{RUN_TOTAL:08d}"),
          f"launcher: last checkpoint {path}")
    meta = ckpt_io.load_metadata(path)
    capsule = trainer.restore_capsule(path, straight.state)
    same_capsule = _capsules_equal(capsule, straight.state)
    returns = np.asarray(meta["metrics"]["returns"])
    same_returns = np.array_equal(returns, straight.episode_returns)
    print(f"run: launcher stopped at {RUN_STOP} and resumed to {RUN_TOTAL} "
          f"vs Session.fit({RUN_TOTAL}) on the card: every capsule leaf "
          f"torch.equal {same_capsule}; episode-return streams equal "
          f"{same_returns} ({len(returns)} episodes); manifest format "
          f"{meta['format']}, runtime {meta['runtime']}")
    check(same_capsule, "launcher resume: capsule differs from Session.fit")
    check(same_returns, "launcher resume: episode returns differ")
    return {"straight": straight, "capsule_equal": same_capsule,
            "returns_equal": same_returns, "episodes": len(returns)}


def _run_faults(tmp: Path, straight) -> dict:
    """(b): a truncated checkpoint and a failed segment, recovered."""
    from repro_torch import api
    spec = api.load(str(QUICKSTART)).replace(
        checkpoint={"dir": str(tmp / "faults"), "every": RUN_EVERY},
        faults={"events": [{"site": "checkpoint", "interval": RUN_STOP,
                            "kind": "truncate"}],
                "max_restarts": 2, "backoff": 0.0, "backoff_cap": 0.0})
    session = _fail_segment_once(api.build(spec, device="cuda"), RUN_STOP)
    rep = session.fit(RUN_TOTAL)
    restored = [r["restored_to"] for r in rep.recoveries]
    same = (_params_equal(rep.params, straight.params)
            and _capsules_equal(rep.state, straight.state)
            and np.array_equal(rep.episode_returns, straight.episode_returns)
            and np.array_equal(rep.rewards, straight.rewards))
    print(f"run: fault plan (checkpoint {RUN_STOP} truncated, the segment "
          f"from {RUN_STOP} failed once, max_restarts 2): restarts "
          f"{rep.restarts}, restored to {restored}; params, capsule, "
          f"episode returns and rewards equal the fault-free fit {same}")
    check(rep.restarts == 1 and restored == [RUN_STOP - RUN_EVERY],
          f"fault plan: restarts {rep.restarts}, restored to {restored}")
    check(same, "fault plan: the recovered fit differs from the fault-free")
    return {"restarts": rep.restarts, "restored_to": restored, "equal": same}


def _first_pass_grads(spec, backend: str) -> float:
    """The largest per-leaf relative error, card vs CPU, of the learner's
    gradient on the first real pass of a spec's run: behavior params and
    ring slot taken from the CPU run's state after K + 1 intervals, the
    same inputs on both devices."""
    from repro_torch.core import delayed_grad, engine, mesh_runtime
    from repro_torch.core.tree import tree_map
    session = build_session(spec, "cpu", env_backend=backend)
    K = session.cfg.staleness
    session.runtime.run(K + 1)
    state = session.runtime.state()
    grad_fn = mesh_runtime.make_grad_fn(session.policy.apply, session.cfg)
    inputs = (delayed_grad.behavior_params(state.algo),
              mesh_runtime.ring_read(state.buffer, K))
    with engine.deterministic_cudnn():
        cpu = grad_fn(*inputs)
        card = grad_fn(*tree_map(lambda x: x.to("cuda"), inputs))
    return max(_rel(card[k], cpu[k]) for k in cpu)


def _run_gridmaze(smi: str) -> dict:
    """(c) and (d): gridmaze card vs CPU on both backends, mlp and CNNs;
    the device backend's rate at n_envs 1024."""
    from repro_torch import api
    base = api.load(str(POOL_B))
    n = base.intervals
    rows = {}
    specs = {"mlp": base, **{name: base.replace(policy=pol)
                             for name, pol in GRIDMAZE_CNNS.items()}}
    for pol_name, spec in specs.items():
        for backend in ("host", "device"):
            card = build_session(spec, "cuda", env_backend=backend).run(n)
            cpu = build_session(spec, "cpu", env_backend=backend).run(n)
            same = _same_streams(card, cpu)
            diff = _params_diff(card.params, cpu.params)
            held = pol_name != "cnn-atari_a2c"
            row = {"streams_equal": same, "params_max_abs_diff": diff}
            extra = ""
            if not held:
                row["first_pass_grads_rel_err"] = _first_pass_grads(
                    spec, backend)
                extra = (f"; first learner pass gradients max relative err "
                         f"{row['first_pass_grads_rel_err']:.3e} (tol "
                         f"{CNN_REL_TOL})")
            print(f"run: gridmaze (scenario {spec.env.kwargs}, {pol_name} "
                  f"{spec.policy.kwargs}, {spec.algorithm}, K="
                  f"{spec.hts['staleness']}, {backend} backend, {n} "
                  f"intervals): card vs CPU streams equal {same}; params "
                  f"max abs diff {diff:.3e} "
                  + (f"(tol {PARAMS_TOL})" if held else "(printed, not held)")
                  + extra + f"; steps {int(card.state.step)}")
            check(same, f"gridmaze {pol_name} {backend}: streams differ")
            if held:
                check(diff <= PARAMS_TOL,
                      f"gridmaze {pol_name} {backend}: params {diff}")
            else:
                check(row["first_pass_grads_rel_err"] <= CNN_REL_TOL,
                      f"gridmaze {pol_name} {backend}: gradients {row}")
                check(bool(torch.isfinite(torch.cat(
                    [p.flatten() for p in card.params.values()])).all()),
                      f"gridmaze {pol_name} {backend}: params not finite")
            rows[f"{pol_name}-{backend}"] = row
    g = GRIDMAZE_SCALE
    rt = build_session(base, "cuda", env_backend="device", alpha=g["alpha"],
                       n_envs=g["n_envs"]).runtime
    runs = _timed_runs(rt, g["intervals"], "gridmaze scale")
    sps = [r.sps for r in runs]
    print(f"run: gridmaze scale times on {smi}: device backend, "
          f"{base.policy.name}, {base.algorithm}, K="
          f"{base.hts['staleness']}, alpha {g['alpha']} x {g['n_envs']} envs "
          f"x {g['intervals']} intervals: env steps/s (3 runs after a "
          "warm-up run) " + ", ".join(f"{x:.1f}" for x in sps))
    return {"cells": rows, "scale_sps": sps}


def _run_guard() -> dict:
    """(e): each kernel refuses a differentiable call, launching nothing,
    and runs once under inference_mode, matching its plain version at
    the tolerance of phase 3."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    gen = torch.Generator(device="cuda").manual_seed(1)
    causal = GUARD_CASES["flash_attention"][5]
    calls = {
        "flash_attention": (
            flash_inputs(GUARD_CASES["flash_attention"], gen), TOL,
            lambda *t, use_kernel=True: fa_ops.attend(
                *t, causal=causal, use_kernel=use_kernel)),
        "lru_scan": (
            lru_inputs(GUARD_CASES["lru_scan"], gen), SCAN_TOL,
            lambda *t, use_kernel=True: lru_ops.scan(
                *t, use_kernel=use_kernel)[0]),
        "wkv6": (
            wkv_inputs(GUARD_CASES["wkv6"], gen), SCAN_TOL,
            lambda *t, use_kernel=True: wkv_ops.mix(
                *t, use_kernel=use_kernel)[0]),
    }
    rows = {}
    for name, (inputs, tols, call) in calls.items():
        grad_in = [x.detach().clone().requires_grad_() for x in inputs]
        refused = []
        for mode, fn in (
                ("autograd", lambda: call(*grad_in)),
                ("torch.func.grad", lambda: torch.func.grad(
                    lambda x0: call(x0, *inputs[1:]).float().sum())(
                        inputs[0]))):
            zero_launches()
            try:
                fn()
                ok = False
            except RuntimeError as e:
                ok = "no backward yet" in str(e)
            ok = ok and read_launches()[name] == 0
            refused.append(ok)
            print(f"run: guard {name} under {mode} with an input that "
                  f"requires grad: refused, nothing launched {ok}")
        zero_launches()
        with torch.inference_mode():
            out = call(*grad_in)
            plain = call(*inputs, use_kernel=False)
        ran = read_launches()[name] == 1
        tol = tols[inputs[0].dtype]
        err = (out.float() - plain.float()).abs().max().item()
        close = torch.allclose(out.float(), plain.float(), atol=tol, rtol=tol)
        print(f"run: guard {name} under inference_mode with the same "
              f"inputs: launched once {ran}; vs plain max abs err "
              f"{err:.3e} (allclose at {tol} {close})")
        check(all(refused), f"guard {name}: a differentiable call ran")
        check(ran and close, f"guard {name}: inference_mode call")
        rows[name] = {"refused": refused, "inference_mode_err": err}
    return rows


def phase_run() -> dict:
    """The entry point on the card (phase 7 of the docstring). The kernel
    launch counts are zeroed before and read after the training paths:
    they launch none of the port's kernels. The guard's calls come after
    that reading."""
    import tempfile
    smi = nvidia_smi()
    zero_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as d:
        tmp = Path(d)
        launcher = _run_launcher(tmp)
        faults = _run_faults(tmp, launcher.pop("straight"))
    gridmaze = _run_gridmaze(smi)
    launches = read_launches()
    print(f"run: launches of the port's kernels on the entry point's paths "
          f"{launches}")
    _expect(launches, {}, "entry point paths")
    res = {"launcher": launcher, "faults": faults, "gridmaze": gridmaze,
           "guard": _run_guard()}
    print("run: " + json.dumps(res))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    name = phase_card()
    phase_build()
    errs = phase_kernels()
    runs = {arch: phase_serve(arch) for arch in SERVE_PATHS}
    phase_train()
    phase_run()

    smi = nvidia_smi()
    print(f"times on {smi}:")
    for arch, run in runs.items():
        print(f"  {arch} prefill {BATCH}x{PROMPT} ms (3 runs): "
              + ", ".join(f"{x:.3f}" for x in run["prefill_ms"]))
        print(f"  {arch} decode tok/s, {BATCH} rows x {GEN - 1} steps "
              "(3 runs): " + ", ".join(f"{x:.1f}" for x in run["tok_s"]))
    times = {"flash_attention": [flash_times(MAIN), flash_times(RG_ATTN)],
             "lru_scan": lru_times(),
             "wkv6": [wkv_times(WKV_MAIN), wkv_times(WKV_DECODE)]}
    print(json.dumps({"kernels": [_entry(k, runs, errs[k], times[k])
                                  for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
