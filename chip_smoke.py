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
   kernels over all of that stay 0 (the kernels' backwards are held in
   phase 10 (a));
8. the threaded host runtime and the baselines (``phase_host``): (a)
   ``python -m repro_torch.launch.run --spec
   examples/specs/quickstart.json --runtime host`` as typed, then
   checkpointed and stopped at 20 and resumed to 40, whose last
   checkpoint equals the ``mesh`` runtime's ``Session.fit(40)`` leaf for
   leaf with the same episode-return stream; (b) host == mesh on the card
   (``torch.equal``) at K 1 and 2, with 1 and 4 actors, with and without
   the football spec's step-time model, and the card's host run against
   the port's CPU (streams exact, params within 1e-5); (c)
   ``examples/atari_a2c.py``'s contenders (mesh, sync, async with
   V-trace at k=8) and the host runtime, 10 intervals each on the card
   against the port's CPU: streams exact, the actions of interval 0 (at
   theta_0) exact, each one's first learner gradient within 1e-4
   relative per leaf; printed: the intervals whose actions differ later,
   the params' distance, beside the same for the CPU run from theta_0
   moved one ulp (what rounding alone does to this CNN under rmsprop),
   and tail rewards; then the host runtime's device memory after 25
   intervals within one parameter tree of that after 5; (d) an
   executor death and a NaN learner update under ``max_restarts`` 2
   recovering to the fault-free fit; (e) env steps/s of host, mesh, sync
   and async at the quickstart spec, the host runtime's profile split,
   and a simulated learner twice as slow as an interval at K 1 and 2
   beside ``staleness_pipeline_runtime``: K=2's last interval ends
   before K=1's (a serial learner slower than the rollout bounds the
   whole run at every K, so the totals are printed, not compared). The
   port's kernels launch 0 times over all of it.
9. data parallelism, serving and tenancy (``phase_scale``): (a)
   ``python -m repro_torch.launch.distributed --spec
   examples/specs/quickstart.json`` as two ranks on the one card (the
   default backend is then gloo, and the gradient sums travel through
   the host) and as one rank (nccl): every rank's params digest equals
   the 1-process ``mesh`` run's; ``examples/atari_a2c.py``'s workload
   (the paper CNN's widths on gridmaze) sharded over two processes at
   grad_accumulation 1 and 2, a ``mesh`` capsule continued on two ranks
   and a two-rank capsule continued on ``mesh``, each ``torch.equal``
   to the straight mesh run, streams equal; env steps/s of mesh, R=1 and
   R=2; (b) ``python -m repro_torch.launch.serve --spec
   examples/specs/quickstart.json --requests 500 --rate 2000`` as typed
   (p50, p99, QPS); for the mlp and the atari_a2c CNN one (obs, seed) at
   every row of a full dispatch and in three batch compositions answers
   one action and logprob bit for bit, and the card's actions equal the
   port's CPU server's on fixed seeds; (c) ``python -m
   repro_torch.launch.pool --spec examples/specs/pool_a.json --spec
   examples/specs/pool_b.json --digest --check-solo`` exits 0,
   ``pool.serve()`` answers as each tenant's solo server, and the pool's
   aggregate env steps/s at max_concurrency 1 and 2 with the Jain
   index. The port's kernels launch 0 times in this process over all of
   it;
10. LLM-policy training (``phase_llm_train``): (a) each kernel's backward
   (flash attention and wkv6: the VJP of the plain version on the saved
   inputs; lru_scan: the kernel again on reversed time) under
   ``.backward()`` and ``torch.func.grad`` against autograd of the plain
   version on the card, at 1e-4 (fp32) and 3e-2 (bf16): the reference
   grad tests' shapes, shapes off the block multiples, soft-cap, GQA,
   window, h0 or none, a cotangent on h_last, mixed dtypes, wkv6 at T 1,
   31, 32, 33, 512 with w = 0, and the training shapes, each printing
   its route; each backward's time at its training shape against its
   plain version's, SDPA's backward (flash) and a bound; (b) ``python -m
   repro_torch.launch.train --arch starcoder2-3b --steps 3 --batch 4
   --seq 512`` as typed (full width and depth: 30 layers, d_model 3072,
   bf16, Adam): finite losses, ms per step and tokens/s after the first
   step, peak memory beside the training state's reckoning, 60 flash
   launches per step; (c) RecurrentGemma-9B (3 layers) and RWKV-6-7B (2
   layers) at full width through ``python -m repro_torch.launch.run
   --spec``, with their launches per step (lru_scan 6 and flash 2; wkv6
   4), then the first step's loss and every gradient leaf, kernels
   against plain versions on the card, in bf16 and in fp32: the loss at
   3e-2 (bf16) and 1e-4 (fp32), each leaf's relative L2 distance printed
   (RWKV-6's beside a witness with the kernel's rounding) and the
   largest held at ``LLM_GRAD_REL_L2`` (fp32 1e-3; bf16 5e-2 for
   RecurrentGemma, none for RWKV-6, whose bf16 gradient moves up to 1.2
   under any change of wkv6's rounding); (d) StarCoder2-3B at full width
   with 2 layers: ``--ckpt-every 2 --steps 2``, then ``--resume --steps
   4``, equal to a straight ``--steps 4`` in every checkpoint leaf; (e)
   each family's reduced config in fp32, 3 stream-runtime steps on the
   card and on the CPU from the same weights: losses
   within 1e-4, SGD's params within 1e-5 of each leaf's largest entry,
   and a rerun on the card bit for bit.

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
# checkpoint and failed segment, gridmaze cells
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

# the host runtime and the baselines (phase_host): intervals of the
# host == mesh cells; the football spec's step-time model (shape 1, rate
# 1, time_scale 0.002) on catch; examples/atari_a2c.py's contenders
# (gridmaze, its CNN, rmsprop, alpha 5, n_envs 8) and the host runtime as
# a fourth, with their interval count; the rate runs' intervals; the
# pipeline runs' intervals
HOST_N = 6
FOOTBALL = ROOT / "examples" / "specs" / "football_ppo.json"
ATARI_SPEC = {
    "env": {"name": "gridmaze"},
    "policy": {"name": "cnn", "kwargs": {"conv_sizes": [3, 3, 3],
                                         "conv_strides": [1, 1, 1],
                                         "hidden": 128}},
    "optimizer": {"name": "rmsprop", "kwargs": {"lr": 7e-4, "eps": 1e-5}},
    "algorithm": "a2c",
    "hts": {"alpha": 5, "n_envs": 8, "seed": 0, "entropy_coef": 0.01}}
ATARI_CONTENDERS = {
    "mesh": ("HTS-RL(A2C)", {}), "sync": ("sync A2C", {}),
    "async": ("async+vtrace (k=8)",
              {"acfg": {"staleness": 8, "correction": "vtrace"}}),
    "host": ("HTS-RL(A2C), threaded", {})}
# 10 intervals keep the whole script near half its time limit
ATARI_INTERVALS = 10
MEM_SHORT, MEM_LONG = 5, 25          # host runtime's memory, intervals
RATE_INTERVALS = 10
PIPE_INTERVALS = 6

# data parallelism, serving and tenancy (phase_scale): the sharded CNN
# runs' intervals (a capsule handed over at half of them); the serving
# launcher's load; the card-vs-CPU serving seeds
SHARD_INTERVALS = 10
SERVE_LOAD = ("--requests", "500", "--rate", "2000")
SERVE_SEEDS = 16
POOL_A = ROOT / "examples" / "specs" / "pool_a.json"

# LLM-policy training (phase_llm_train). (a): each kernel's backward
# against autograd of its plain version, at tests/test_kernels.py's
# tolerances: flash at the reference grad test's case, off the blocks,
# soft-capped, GQA and at the training shapes (StarCoder2-3B's and
# RecurrentGemma-9B's attention at B 4, S 512); lru_scan at the reference
# grad test's shape with and without h0, off the blocks, in bf16, with
# mixed dtypes and at RecurrentGemma's (4, 512, 4096); wkv6 at T 1, 31,
# 32, 33, 512 with a tenth of w = 0, and at RWKV-6's (4, 512, 64, 64)
TRAIN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
MAIN_TRAIN = (4, 512, 24, 2, 128, True, 0, 0.0, 128, 128, torch.bfloat16)
RG_TRAIN = (4, 512, 16, 1, 256, True, 2048, 0.0, 128, 128, torch.bfloat16)
TRAIN_FLASH = [
    (2, 48, 4, 2, 16, True, 16, 0.0, 32, 32, torch.float32),
    (1, 80, 2, 1, 16, True, 32, 0.0, 16, 16, torch.bfloat16),
    (1, 80, 2, 1, 16, True, 32, 0.0, 32, 32, torch.float32),
    (1, 96, 4, 4, 32, True, 0, 50.0, 32, 32, torch.float32),
    (2, 192, 4, 2, 256, False, 0, 0.0, 128, 128, torch.bfloat16),
    MAIN_TRAIN, RG_TRAIN,
]
LRU_TRAIN = (4, 512, 4096, torch.float32)
TRAIN_LRU = [((2, 32, 8, torch.float32), True),
             ((2, 32, 8, torch.float32), False),
             ((2, 50, 48, torch.float32), True),
             ((3, 300, 600, torch.bfloat16), True),
             ((2, 70, 136, torch.float32, torch.bfloat16), True),
             ((2, 70, 136, torch.bfloat16, torch.float32), False),
             (LRU_TRAIN, False)]
WKV_TRAIN = (4, 512, 64, 64, torch.bfloat16)
TRAIN_WKV = [((2, T, 4, 64, torch.float32), "zero")
             for T in (1, 31, 32, 33, 512)] + [(WKV_TRAIN, "reference")]
# (b): the main path as a user types it; its flash launches per step (30
# layers, forward and the checkpointed layer's recompute)
LLM_TRAIN = ("--arch", "starcoder2-3b", "--steps", "3", "--batch", "4",
             "--seq", "512")
LLM_STEPS, LLM_BATCH, LLM_SEQ = 3, 4, 512
LLM_FLASH_PER_STEP = 60
# (c): the other families at full width, depth cut: arch -> (n_layers,
# launches per step). RecurrentGemma's one (rglru, rglru, local) cycle:
# lru_scan forward, recompute and backward in 2 layers, flash forward
# and recompute in 1; RWKV-6: wkv6 forward and recompute in 2 layers
LLM_SPEC_RUNS = {"recurrentgemma-9b": (3, {"lru_scan": 6,
                                           "flash_attention": 2}),
                 "rwkv6-7b": (2, {"wkv6": 4})}
LLM_SPEC_STEPS = 2
LLM_LOSS_TOL = 3e-2      # bf16, kernels vs plain versions, first step
# (c) the largest per-leaf relative L2 gradient distance, kernels vs
# plain versions, by dtype and family, read over seeds by
# ``scripts/llm_grad_spread.py``. In fp32 the kernels' largest over 18
# RWKV-6 seeds is 4.9e-4. RWKV-6's bf16 gradient is not bounded, only
# printed: there any change of wkv6's rounding, the kernel's or a plain
# witness's, moves a leaf 4e-4 to 1.2 by seed (its recurrence turns a
# flipped bf16 bit into a large gradient change on some inputs)
LLM_GRAD_REL_L2 = {"bfloat16": {"recurrentgemma-9b": 5e-2},
                   "float32": {"recurrentgemma-9b": 1e-3,
                               "rwkv6-7b": 1e-3}}
# (d): StarCoder2-3B at full width with its depth cut for the resume
LLM_RESUME_LAYERS = 2
# (e): reduced fp32 configs, card vs CPU over 3 steps
LLM_KERNELS = {"starcoder2-3b": ("flash_attention",),
               "recurrentgemma-9b": ("lru_scan", "flash_attention"),
               "rwkv6-7b": ("wkv6",)}
CARD_CPU_LOSS_TOL = 1e-4
CARD_CPU_PARAMS_TOL = 1e-5


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


def _entry(name: str, runs: dict, err: float, times: list,
           llm: dict) -> dict:
    """A kernel's row of the ``{"kernels": ...}`` line. ``launches`` sums
    the main paths' runs: the three serving paths and the training
    paths of ``phase_llm_train`` (b) and (c); ``backward`` is the
    backward's time at its training shape, ``backward_max_abs_err`` the
    largest error of phase 10 (a)."""
    runs = dict(runs)
    runs["train starcoder2-3b"] = {
        "launches": llm["starcoder2"]["launches"], "lru_scan_tma": 0}
    for arch, fam in llm["families"].items():
        runs[f"train {arch}"] = {"launches": fam["launches"],
                                 "lru_scan_tma": fam["lru_scan_tma"]}
    by_path = {arch: run["launches"][name] for arch, run in runs.items()
               if run["launches"][name]}
    first = times[0]
    extra = {"backward": llm["backward_times"][name],
             "backward_max_abs_err": max(
                 row["max_abs_err"] for row in llm["backward"][name])}
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
def _launcher(args: list, what: str, tag: str) -> str:
    """``python -m repro_torch.launch.run ARGS`` from the checkout, as a
    user runs it; its output printed, a non-zero exit a failure."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.run", *args], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=600)
    print(f"{tag}: {what}: python -m repro_torch.launch.run "
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


def _run_launcher(tmp: Path, runtime: str = "mesh") -> dict:
    """(a) of phase_run and of phase_host: the launcher as typed (with
    ``--runtime`` where the spec's is not the one asked for), then
    stopped and resumed, against the ``mesh`` runtime's uninterrupted
    ``Session.fit`` on the card."""
    from repro_torch import api
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import trainer
    quick = str(QUICKSTART.relative_to(ROOT))
    spec = api.load(str(QUICKSTART))
    pick = [] if runtime == spec.runtime.name else ["--runtime", runtime]
    tag = "run" if runtime == "mesh" else "host"     # the phase's prefix
    _launcher(["--spec", quick, *pick],
              "the quickstart spec" + (f" on the {runtime} runtime" if pick
                                       else ", no other flag"), tag)
    ck = tmp / f"{runtime}_launcher"
    common = ["--spec", quick, *pick, "--ckpt-dir", str(ck), "--ckpt-every",
              str(RUN_EVERY)]
    _launcher(common + ["--intervals", str(RUN_STOP)],
              f"checkpointed, stopped at {RUN_STOP}", tag)
    out = _launcher(common + ["--intervals", str(RUN_TOTAL), "--resume"],
                    f"resumed to {RUN_TOTAL}", tag)
    check(f"{RUN_TOTAL} intervals ({RUN_STOP} resumed)" in out,
          f"{runtime} launcher: the resumed run did not report its resume")
    straight = api.build(spec.replace(checkpoint={
        "dir": str(tmp / f"{runtime}_straight"), "every": RUN_EVERY}),
        device="cuda").fit(RUN_TOTAL)
    path = ckpt_io.latest(str(ck))
    check(path is not None and path.endswith(f"step_{RUN_TOTAL:08d}"),
          f"{runtime} launcher: last checkpoint {path}")
    meta = ckpt_io.load_metadata(path)
    capsule = trainer.restore_capsule(path, straight.state)
    same_capsule = _capsules_equal(capsule, straight.state)
    returns = np.asarray(meta["metrics"]["returns"])
    same_returns = np.array_equal(returns, straight.episode_returns)
    print(f"{tag}: launcher{' ' + ' '.join(pick) if pick else ''} stopped "
          f"at {RUN_STOP} and resumed to {RUN_TOTAL} vs the mesh runtime's "
          f"Session.fit({RUN_TOTAL}) on the card: every capsule leaf "
          f"torch.equal {same_capsule}; episode-return streams equal "
          f"{same_returns} ({len(returns)} episodes); manifest format "
          f"{meta['format']}, runtime {meta['runtime']}")
    check(meta["runtime"] == runtime, f"{runtime} launcher: manifest runtime")
    check(same_capsule, f"{runtime} launcher resume: capsule differs from "
          "Session.fit")
    check(same_returns, f"{runtime} launcher resume: episode returns differ")
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


def _first_grads_err(session) -> float:
    """The largest per-leaf relative error, card vs CPU, of a runtime's
    first learner gradient: interval 0's trajectory at the initial
    params (collected on the CPU) through the runtime's own ``grad_fn``
    (the per-env tree sum for mesh and host, ``grad`` of the interval
    loss for sync, of the stale loss for async)."""
    from repro_torch.core import determinism, engine, rollout
    from repro_torch.core.tree import tree_map
    cfg, rt, apply = session.cfg, session.runtime, session.policy.apply
    rt.init()
    env_state, obs = rt.venv.reset(determinism.split(
        determinism.master_key(cfg.seed ^ 0x5EED), cfg.n_envs))
    traj, _, _ = rollout.rollout_interval(
        apply, rt.venv, session.params, env_state, obs,
        determinism.master_key(cfg.seed), 0,
        rollout.RolloutConfig(cfg.alpha, cfg.n_envs))
    with engine.deterministic_cudnn():
        cpu = rt.grad_fn(session.params, traj)
        card = rt.grad_fn(*tree_map(lambda x: x.to("cuda"),
                                    (session.params, traj)))
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
            sessions = [build_session(spec, where, env_backend=backend)
                        for where in ("cuda", "cpu")]
            actions = [_record_actions(x) for x in sessions]
            card, cpu = (x.run(n) for x in sessions)
            same = _same_streams(card, cpu)
            diff = _params_diff(card.params, cpu.params)
            held = pol_name != "cnn-atari_a2c"
            row = {"streams_equal": same, "params_max_abs_diff": diff}
            extra = ""
            if not held:
                # no episode ends in this window: the streams show no
                # action, so interval 0's (at theta_0) are held too
                row["interval0_actions_equal"] = np.array_equal(
                    actions[0][0], actions[1][0])
                row["first_pass_grads_rel_err"] = _first_grads_err(
                    build_session(spec, "cpu", env_backend=backend))
                extra = (f"; interval 0's actions equal "
                         f"{row['interval0_actions_equal']}; first learner "
                         f"pass gradients max relative err "
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
                check(row["interval0_actions_equal"],
                      f"gridmaze {pol_name} {backend}: interval 0's actions")
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


def phase_run() -> dict:
    """The entry point on the card (phase 7 of the docstring). The kernel
    launch counts are zeroed before and read after the training paths:
    they launch none of the port's kernels."""
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
    res = {"launcher": launcher, "faults": faults, "gridmaze": gridmaze}
    print("run: " + json.dumps(res))
    return res


# ------------------------------------------- host runtime, baselines
def _host_faults(tmp: Path) -> dict:
    """(d): an executor death and a NaN learner update on the host
    runtime under ``max_restarts`` 2, against the fault-free fit."""
    from repro_torch import api
    spec = api.load(str(QUICKSTART)).replace(
        runtime="host", intervals=8,
        checkpoint={"dir": str(tmp / "host_clean"), "every": 2})
    clean = api.build(spec, device="cuda").fit()
    chaos = spec.replace(
        checkpoint={"dir": str(tmp / "host_chaos"), "every": 2},
        faults={"events": [{"site": "executor", "interval": 3},
                           {"site": "learner", "interval": 4,
                            "kind": "nan"}],
                "max_restarts": 2, "backoff": 0.0, "backoff_cap": 0.0})
    rep = api.build(chaos, device="cuda").fit()
    restored = [r["restored_to"] for r in rep.recoveries]
    failures = [r["failure"].split(":")[0] for r in rep.recoveries]
    same = (_params_equal(rep.params, clean.params)
            and _capsules_equal(rep.state, clean.state)
            and np.array_equal(rep.episode_returns, clean.episode_returns)
            and np.array_equal(rep.rewards, clean.rewards))
    print(f"host: fault plan on the host runtime (executor exc at 3, "
          f"learner nan at 4, a checkpoint every 2, max_restarts 2): "
          f"restarts {rep.restarts} ({failures}), restored to {restored};"
          f" params, capsule, episode returns and rewards equal the "
          f"fault-free fit {same}")
    check(rep.restarts == 2 and restored == [2, 4],
          f"host fault plan: restarts {rep.restarts}, restored {restored}")
    check(same, "host fault plan: the recovered fit differs")
    return {"restarts": rep.restarts, "restored_to": restored,
            "failures": failures, "equal": same}


def _host_equals_mesh() -> dict:
    """(b): host == mesh on the card, ``torch.equal``, at K 1 and 2, with
    1 and 4 actors, with and without the football spec's step-time
    model; the card's host run against the port's CPU host run."""
    from repro_torch import api
    base = api.load(str(QUICKSTART))
    fb = api.load(str(FOOTBALL)).runtime.kwargs["host"]
    skew = {k: fb[k] for k in ("step_time", "time_scale")}
    rows = {}
    for K in (1, 2):
        mesh = build_session(base, "cuda", staleness=K).run(HOST_N)
        for n_actors in (1, 4):
            for skewed in (False, True):
                kw = {"n_actors": n_actors, **(skew if skewed else {})}
                spec = base.replace(runtime={"name": "host",
                                             "kwargs": {"host": kw}})
                card = build_session(spec, "cuda", staleness=K).run(HOST_N)
                same = (_params_equal(card.params, mesh.params)
                        and _same_streams(card, mesh)
                        and int(card.state.step) == int(mesh.state.step))
                cell = f"K={K} actors={n_actors}" + (" skewed" if skewed
                                                     else "")
                print(f"host: quickstart spec, {HOST_N} intervals, {cell}: "
                      f"host == mesh on the card (params torch.equal, "
                      f"streams) {same}")
                check(same, f"host == mesh on the card: {cell}")
                rows[cell] = same
        cpu = build_session(base.replace(runtime="host"), "cpu",
                            staleness=K).run(HOST_N)
        same = _same_streams(card, cpu)
        diff = _params_diff(card.params, cpu.params)
        print(f"host: K={K}: card vs the port's CPU (host runtime): "
              f"streams equal {same}; params max abs diff {diff:.3e} (tol "
              f"{PARAMS_TOL})")
        check(same and diff <= PARAMS_TOL, f"host K={K}: card vs CPU")
        rows[f"K={K} card vs CPU"] = {"streams_equal": same,
                                      "params_max_abs_diff": diff}
    return rows


class _ActionTap:
    """A batched env whose every step also hands its actions to ``on``."""

    def __init__(self, env, on):
        self._env, self._on = env, on

    def __getattr__(self, name):
        return getattr(self._env, name)

    def step(self, state, actions, keys):
        self._on(actions.to("cpu", copy=True).numpy())
        return self._env.step(state, actions, keys)


def _record_actions(session) -> list:
    """Collects the actions of every interval of the session's next run,
    (alpha, n_envs) each: what a scan runtime hands its env step, what
    the host runtime's executors wrote into the interval's slab (its
    env step takes all rows, the unrequested ones masked)."""
    rt, seen = session.runtime, []
    if rt.name == "host":
        session.on_interval(lambda m: seen.append(
            rt._slabs.write_view(m["interval"])[0]["actions"].copy()))
        return seen
    steps = []

    def on(actions):
        steps.append(actions)
        if len(steps) == rt.cfg.alpha:
            seen.append(np.stack(steps))
            steps.clear()

    rt.venv = _ActionTap(rt.venv, on)       # before the step is built
    return seen


def _flipped(a: list, b: list) -> list:
    """The intervals whose actions differ between two recorded runs."""
    return [j for j, (x, y) in enumerate(zip(a, b))
            if not np.array_equal(x, y)]


def _atari_contenders() -> dict:
    """(c): examples/atari_a2c.py's contenders and the host runtime, on
    the card against the port's CPU. Held: the reward and done streams
    exact, the actions of interval 0 (every contender's rollout at
    theta_0) exact, the first learner pass's gradients at CNN_REL_TOL
    per leaf. No episode reaches the goal in this window, so the streams
    alone would not show the actions. After the first update the params
    part by rounding, which rmsprop amplifies until an action flips; the
    witness beside each contender is the CPU run again from theta_0
    moved by one ulp: where its actions first flip, and its params'
    distance. Printed, with tail rewards."""
    from repro_torch import api
    from repro_torch.core.tree import tree_map
    rows = {}
    for name, (label, kw) in ATARI_CONTENDERS.items():
        spec = api.from_dict({**ATARI_SPEC, "intervals": ATARI_INTERVALS,
                              "runtime": {"name": name, "kwargs": kw}})
        runs = {}
        for where in ("card", "cpu", "ulp"):
            session = api.build(spec, device="cpu" if where != "card"
                                else "cuda")
            if where == "ulp":
                session.runtime.params0 = tree_map(
                    lambda p: torch.nextafter(p, torch.full_like(p, np.inf)),
                    session.runtime.params0)
            actions = _record_actions(session)
            runs[where] = (session.run(), actions, session)
        (card, card_a, _), (cpu, cpu_a, cpu_session), (ulp, ulp_a, _) = (
            runs["card"], runs["cpu"], runs["ulp"])
        check(len(card_a) == len(cpu_a) == ATARI_INTERVALS,
              f"atari_a2c {name}: recorded {len(card_a)}, {len(cpu_a)} "
              "intervals of actions")
        same = _same_streams(card, cpu)
        goals = int((np.asarray(cpu.rewards) > 0).sum())
        flips, ulp_flips = _flipped(card_a, cpu_a), _flipped(ulp_a, cpu_a)
        err = _first_grads_err(cpu_session)
        diff = _params_diff(card.params, cpu.params)
        ulp_diff = _params_diff(ulp.params, cpu.params)
        r = card.rewards
        tail = float(r[-max(1, len(r) // 5):].mean())
        print(f"host: atari_a2c {label} ({name}; gridmaze, CNN 32/64/64 "
              f"3x3 fc 128, rmsprop, alpha 5, n_envs 8, {ATARI_INTERVALS} "
              f"intervals): card vs CPU streams equal {same} ({goals} goal "
              f"hits); interval 0's actions equal {0 not in flips}; "
              f"intervals with a differing action {flips} (printed); first "
              f"learner pass gradients max relative err {err:.3e} (tol "
              f"{CNN_REL_TOL}); params max abs diff {diff:.3e} (printed); "
              f"tail reward/step (last 20%) {tail:+.4f}")
        print(f"host: atari_a2c {name}: witness, the CPU run from theta_0 "
              f"moved one ulp: intervals with a differing action "
              f"{ulp_flips}; params max abs diff {ulp_diff:.3e}")
        check(same, f"atari_a2c {name}: card streams differ from the CPU's")
        check(0 not in flips, f"atari_a2c {name}: interval 0's actions "
              "differ from the CPU's")
        check(err <= CNN_REL_TOL, f"atari_a2c {name}: gradients {err}")
        rows[name] = {"streams_equal": same, "goal_hits": goals,
                      "flipped_intervals": flips, "first_grads_rel_err": err,
                      "params_max_abs_diff": diff,
                      "ulp_flipped_intervals": ulp_flips,
                      "ulp_params_max_abs_diff": ulp_diff,
                      "tail_reward": tail}
    return rows


def _host_memory() -> dict:
    """The host runtime holds no more device memory after a long segment
    than after a short one: with the atari_a2c CNN, ``memory_allocated``
    after run(MEM_LONG) within one parameter tree of that after
    run(MEM_SHORT). A finished learner submission kept alive would hold
    a gradient tree and a whole DelayedGradState per interval."""
    import gc
    from repro_torch import api
    spec = api.from_dict({**ATARI_SPEC, "runtime": "host"})
    rt = api.build(spec, device="cuda").runtime
    used, workspaces = {}, {}
    for n in (MEM_SHORT, MEM_LONG):
        rt.run(n)
        gc.collect()
        torch.cuda.synchronize()
        # cuBLAS keeps a workspace (32 MiB under CUBLAS_WORKSPACE_CONFIG
        # :4096:8) for every (handle, stream) it has served, and a
        # segment's new threads may draw other handles from the pool:
        # the workspaces go before the reading
        before = torch.cuda.memory_allocated()
        torch._C._cuda_clearCublasWorkspaces()
        used[n] = torch.cuda.memory_allocated()
        workspaces[n] = before - used[n]
    tree = sum(p.numel() * p.element_size() for p in rt.params0.values())
    grew = used[MEM_LONG] - used[MEM_SHORT]
    print(f"host: device memory of the host runtime (atari_a2c CNN, "
          f"{tree} bytes of params), cuBLAS workspaces cleared: "
          f"allocated after run({MEM_SHORT}) {used[MEM_SHORT]}, after "
          f"run({MEM_LONG}) {used[MEM_LONG]} bytes; grew {grew} (held "
          f"under one parameter tree); workspaces cleared "
          f"{workspaces[MEM_SHORT]}, {workspaces[MEM_LONG]} bytes")
    check(grew < tree, f"host runtime memory grew {grew} bytes over "
          f"{MEM_LONG - MEM_SHORT} more intervals")
    return {"allocated": used, "grew": grew, "params_bytes": tree,
            "workspaces_cleared": workspaces}


def _host_rates(smi: str) -> dict:
    """(e): env steps/s of the four runtimes at the quickstart spec, the
    host runtime's profile split, and the staleness pipeline under a
    simulated learner twice as slow as an interval."""
    from repro_torch import api
    from repro_torch.core.runtime_model import staleness_pipeline_runtime
    base = api.load(str(QUICKSTART)).replace(intervals=RATE_INTERVALS)
    n = RATE_INTERVALS
    sps = {}
    for name in ("host", "mesh", "sync", "async"):
        rt = build_session(base.replace(runtime=name), "cuda").runtime
        rt.run(n)                                   # warm-up, excluded
        runs = [rt.run(n) for _ in range(3)]
        check(all(_same_streams(runs[0], r) for r in runs[1:]),
              f"rates {name}: reruns differ")
        sps[name] = [r.sps for r in runs]
    print(f"host: rates on {smi}: quickstart spec (catch, mlp, a2c, alpha "
          f"{base.hts['alpha']} x {base.hts['n_envs']} envs) x {n} "
          "intervals, env steps/s (3 runs after a warm-up): " + "; ".join(
              f"{k} " + ", ".join(f"{x:.1f}" for x in v)
              for k, v in sps.items()))
    prof = build_session(base.replace(runtime={
        "name": "host", "kwargs": {"host": {"profile": True}}}),
        "cuda").runtime
    prof.run(n)
    out = prof.run(n)
    split = dict(sorted(prof.profile.items()))
    print(f"host: profile split on {smi} ({n} intervals, wall "
          f"{out.wall_time:.3f} s, seconds summed over threads): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    # per-interval times from the coordinator's interval ends
    rt = build_session(base.replace(runtime="host"), "cuda").runtime
    rt.run(PIPE_INTERVALS)
    stamps = []
    rt.on_interval = lambda j, m: stamps.append(time.perf_counter())
    t0 = time.perf_counter()
    rt.run(PIPE_INTERVALS)
    R = np.diff([t0] + stamps)
    r = float(np.median(R))
    L = 2.0 * r
    pipe = {"interval_s": R.tolist(), "learner_time_s": L}
    for K in (1, 2):
        spec = base.replace(runtime={"name": "host", "kwargs": {
            "host": {"learner_time": L}}})
        rt = build_session(spec, "cuda", staleness=K).runtime
        stamps = []
        rt.on_interval = lambda j, m: stamps.append(time.perf_counter())
        t0 = time.perf_counter()
        wall = rt.run(PIPE_INTERVALS).wall_time
        rollout = stamps[-1] - t0
        # the model's t_end[-1] (the last interval's end) is its total
        # with the last K learner passes taken out: no interval waits on
        # them
        Rs, Ls = np.full(PIPE_INTERVALS, r), np.full(PIPE_INTERVALS, L)
        drained = staleness_pipeline_runtime(Rs, Ls, K)
        Ls[-K:] = 0.0
        ends = staleness_pipeline_runtime(Rs, Ls, K)
        pipe[f"K={K}"] = {"wall_s": wall, "rollout_end_s": rollout,
                          "model_s": drained, "model_rollout_end_s": ends}
        print(f"host: pipeline on {smi}, K={K}, learner_time {L:.4f} s "
              f"(twice the median interval {r:.4f} s), {PIPE_INTERVALS} "
              f"intervals: the last interval ended at {rollout:.3f} s "
              f"(staleness_pipeline_runtime's t_end {ends:.3f} s); the run, "
              f"learner backlog included, {wall:.3f} s (model "
              f"{drained:.3f} s)")
    # a serial learner slower than the rollout bounds the whole run at
    # every K (the model gives K=1 and K=2 the same total); what K=2
    # buys is one more interval of rollout ahead of it, so its last
    # interval ends one learner_time sooner
    check(pipe["K=2"]["rollout_end_s"] < pipe["K=1"]["rollout_end_s"],
          f"pipeline: K=2's rollout did not end before K=1's {pipe}")
    return {"sps": sps, "profile": split, "pipeline": pipe}


def phase_host() -> dict:
    """The host runtime and the baselines on the card (phase 8 of the
    docstring). The kernel launch counts are zeroed before and read
    after: these paths launch none of the port's kernels."""
    import tempfile
    smi = nvidia_smi()
    t0 = time.perf_counter()
    zero_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_host_") as d:
        tmp = Path(d)
        launcher = _run_launcher(tmp, "host")
        launcher.pop("straight")
        res = {"launcher": launcher, "faults": _host_faults(tmp)}
    res["host_equals_mesh"] = _host_equals_mesh()
    res["atari_a2c"] = _atari_contenders()
    res["memory"] = _host_memory()
    res["rates"] = _host_rates(smi)
    launches = read_launches()
    print(f"host: launches of the port's kernels on the host runtime and "
          f"baselines paths {launches}")
    _expect(launches, {}, "host runtime and baselines paths")
    print(f"host: phase {time.perf_counter() - t0:.1f} s")
    print("host: " + json.dumps(res))
    return res


# ---------------------------------------------- data parallel, serving
def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _processes(argvs: list, what: str, tag: str) -> list:
    """``python ARGV`` for each argv, all started together from the
    checkout, as a user starts them; their output printed, a non-zero
    exit or a hang past 600 s a failure. Every process is waited for (or
    killed) before this returns."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for argv, proc, (out, err) in zip(argvs, procs, outs):
        print(f"{tag}: {what}: python {' '.join(argv)} -> exit "
              f"{proc.returncode} ({time.perf_counter() - t0:.1f}s for all)")
        for line in out.splitlines():
            print(f"  | {line}")
        check(proc.returncode == 0,
              f"{what} exited {proc.returncode}: {err[-3000:]}")
    return [out for out, _ in outs]


def _atari_spec(**batch):
    """examples/atari_a2c.py's workload (gridmaze, the paper CNN's
    widths, a2c, rmsprop, alpha 5 x 8 envs) with a batch geometry."""
    from repro_torch import api
    return api.from_dict({**ATARI_SPEC, "batch": batch})


def _scale_worker(rank: int, tmp: str) -> None:
    """One of the two ranks of ``_scale_sharded`` (its own process, gloo
    on the one card): the atari_a2c workload sharded R=2 at
    grad_accumulation 1 and 2, the mesh capsule continued, and a sharded
    capsule handed back. Results go to ``tmp/rank<rank>.pt``."""
    from repro_torch.core import distributed
    from repro_torch.core.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backend = distributed.initialize(f"file://{tmp}/init", 2, rank,
                                     device="cuda")
    check(backend == "gloo", f"two ranks on one card took {backend}")
    n, half = SHARD_INTERVALS, SHARD_INTERVALS // 2
    cpu = lambda tree: tree_map(lambda x: x.cpu(), tree)   # noqa: E731
    out = {"backend": backend}
    for A in (1, 2):
        spec = _atari_spec(n_replicas=2, grad_accumulation=A)
        rt = build_session(spec.replace(runtime="sharded"), "cuda").runtime
        r = rt.run(n)
        # the rerun's rate: the first run pays the process's warm-up
        again = rt.run(n)
        check(_params_equal(r.params, again.params),
              f"sharded R=2 A={A}: a rerun differs")
        out[f"A{A}"] = {"params": cpu(r.params), "rewards": r.rewards,
                        "dones": r.dones, "sps": again.sps}
    session = build_session(_atari_spec(n_replicas=2).replace(
        runtime="sharded"), "cuda")
    check(session.runtime.n_shards == 2, "the worker's runtime is not R=2")
    cap = torch.load(f"{tmp}/mesh_capsule.pt", weights_only=False)
    out["from_mesh"] = cpu(session.run_from(cap, n - half).params)
    session.run(half)
    out["capsule"] = cpu(session.state())
    torch.save(out, f"{tmp}/rank{rank}.pt")
    torch.distributed.destroy_process_group()


def _scale_sharded(smi: str) -> dict:
    """(a): the launcher as two gloo ranks on the card and as one nccl
    rank, against the mesh run's digest; the atari_a2c CNN sharded R=2
    (two processes) against mesh, ``torch.equal``; capsules across
    replica counts; env steps/s of R=1 and R=2 beside mesh."""
    import tempfile
    from repro_torch import api
    from repro_torch.launch.distributed import params_digest
    spec = api.load(str(QUICKSTART))
    mesh = build_session(spec, "cuda").run(spec.intervals)
    want = params_digest(mesh.params)
    res = {"quickstart": {"mesh_sps": mesh.sps}}
    for n_proc, backend, route in ((2, "gloo", "host"), (1, "nccl", "device")):
        port = _free_port()
        outs = _processes(
            [["-m", "repro_torch.launch.distributed", "--spec",
              str(QUICKSTART), "--coordinator", f"127.0.0.1:{port}",
              "--num-processes", str(n_proc), "--process-id", str(i)]
             for i in range(n_proc)],
            f"{n_proc} rank(s) on the card", "scale")
        lines = [json.loads(o.strip().splitlines()[-1]) for o in outs]
        same = all(x["params_sha256"] == want for x in lines)
        print(f"scale: launcher, {n_proc} rank(s), backend "
              f"{[x['backend'] for x in lines]}, gradient gather "
              f"{[x['gather'] for x in lines]}: digests equal the 1-process "
              f"mesh run's {want[:16]}... {same}")
        check(same, f"launcher {n_proc} ranks: digests {lines} != {want}")
        check(all(x["backend"] == backend and x["gather"] == route
                  for x in lines), f"launcher {n_proc} ranks: {lines}")
        res["quickstart"][f"R={n_proc}_sps"] = [x["sps"] for x in lines]

    n, half = SHARD_INTERVALS, SHARD_INTERVALS // 2
    mesh_rt = build_session(_atari_spec(), "cuda").runtime
    straight = mesh_rt.run(n)
    r1_rt = build_session(_atari_spec().replace(runtime="sharded"),
                          "cuda").runtime
    r1 = r1_rt.run(n)
    check(_params_equal(r1.params, straight.params)
          and _same_streams(r1, straight),
          "sharded without a process group differs from mesh")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        first = build_session(_atari_spec(), "cuda")
        first.run(half)
        torch.save(first.state(), f"{tmp}/mesh_capsule.pt")
        _processes([["-c", f"import chip_smoke as c; c._scale_worker({i}, "
                           f"{tmp!r})"] for i in range(2)],
                   "atari_a2c sharded R=2 ranks", "scale")
        ranks = [torch.load(f"{tmp}/rank{i}.pt", weights_only=False)
                 for i in range(2)]
    cells = {}
    for A in (1, 2):
        got = [r[f"A{A}"] for r in ranks]
        eq = all(_params_equal(g["params"], straight.params)
                 and _same_streams(_SavedStreams(g["rewards"], g["dones"]),
                                   straight) for g in got)
        cells[f"R=2,A={A}"] = eq
    cells["mesh capsule -> sharded R=2"] = all(
        _params_equal(r["from_mesh"], straight.params) for r in ranks)
    back = build_session(_atari_spec(), "cuda").run_from(ranks[0]["capsule"],
                                                         n - half)
    cells["sharded R=2 capsule -> mesh"] = _params_equal(back.params,
                                                         straight.params)
    print(f"scale: atari_a2c (gridmaze, CNN {ATARI_SPEC['policy']['kwargs']},"
          f" alpha {ATARI_SPEC['hts']['alpha']} x "
          f"{ATARI_SPEC['hts']['n_envs']} envs, {n} intervals, capsules at "
          f"{half}) sharded against mesh on the card, torch.equal params and "
          f"equal streams: {json.dumps(cells)}; sharded with no group "
          "equals mesh True")
    check(all(cells.values()), f"sharded vs mesh on the card: {cells}")
    # rates from reruns: each first run paid its process's warm-up
    mesh_sps, r1_sps = mesh_rt.run(n).sps, r1_rt.run(n).sps
    res["atari_a2c"] = {
        "cells": cells, "mesh_sps": mesh_sps, "R=1_sps": r1_sps,
        "R=2_sps": {f"A={A}": [r[f"A{A}"]["sps"] for r in ranks]
                    for A in (1, 2)}}
    print(f"scale: rates on {smi}, env steps/s (each rank counts the global "
          f"env steps; the two ranks share the one card): quickstart mesh "
          f"{res['quickstart']['mesh_sps']:.1f}, R=1 (nccl) "
          f"{res['quickstart']['R=1_sps']}, R=2 (gloo) "
          f"{res['quickstart']['R=2_sps']} (each the first run of its "
          f"process); atari_a2c, a rerun each: mesh {mesh_sps:.1f}, "
          f"sharded R=1 {r1_sps:.1f}, R=2 {res['atari_a2c']['R=2_sps']}")
    return res


@dataclasses.dataclass
class _SavedStreams:
    """A rank's saved streams, as ``_same_streams`` reads them."""
    rewards: np.ndarray
    dones: np.ndarray


def _staged(session, reqs: list) -> list:
    """``reqs`` (obs, seed) queued on an unstarted server of the session,
    in order, so that one dispatch takes them all; their results."""
    srv = session.serve(start=False)
    futs = [srv.submit(o, seed=sd) for o, sd in reqs]
    srv.start()
    try:
        return [f.result(timeout=120) for f in futs]
    finally:
        srv.stop()


def _serve_rows() -> dict:
    """(b): the same (obs, seed) at every row of a full dispatch and in
    three batch compositions gives one action and logprob, bit for bit,
    for the mlp and the atari_a2c CNN; the card's actions equal the
    port's CPU server's on fixed seeds."""
    from repro_torch import api
    from repro_torch.serve.loadgen import reset_obs
    from repro_torch.serve.server import PolicyServer, obs_template
    specs = {"mlp": api.load(str(QUICKSTART)),
             "cnn-atari_a2c": _atari_spec()}
    rows = {}
    for name, spec in specs.items():
        session = build_session(spec, "cuda")
        B = spec.serve.max_batch
        obs = reset_obs(session.env, 2 * B, 0)
        probe = (obs[0], 7)
        fill = [(obs[1 + i], 100 + i) for i in range(B - 1)]
        other = [(obs[B + i], 500 + i) for i in range(B - 1)]
        got = {}
        for p in range(B):
            out = _staged(session, fill[:p] + [probe] + fill[p:])[p]
            check(out.batch_size == B, f"serve {name}: row {p} batch "
                  f"{out.batch_size}")
            got[f"row {p}"] = out
        got["alone"] = _staged(session, [probe])[0]
        got["half, other requests"] = _staged(
            session, other[:B // 2 - 1] + [probe])[-1]
        got["full, other requests"] = _staged(session, [probe] + other)[0]
        ref = got["row 0"]
        bad = [k for k, v in got.items()
               if (v.action, v.logprob) != (ref.action, ref.logprob)]
        print(f"serve {name}: one (obs, seed) at each of the {B} rows of a "
              f"full dispatch and in 3 compositions (alone, half with other "
              f"requests, full with other requests): action {ref.action}, "
              f"logprob {ref.logprob!r}; positions that differ: {bad}")
        check(not bad, f"serve {name}: rows differ {bad}: "
              + "; ".join(f"{k} {got[k]}" for k in bad))
        cpu = PolicyServer(session.policy.apply, session.params,
                           obs_like=obs_template(session.env),
                           serve=spec.serve, seed=session.cfg.seed,
                           device="cpu").start()
        card = session.serve()
        try:
            pairs = [(card.act(obs[i], seed=i, timeout=120),
                      cpu.act(obs[i], seed=i, timeout=120))
                     for i in range(SERVE_SEEDS)]
        finally:
            card.stop()
            cpu.stop()
        same = all(a.action == b.action for a, b in pairs)
        lp = max(abs(a.logprob - b.logprob) for a, b in pairs)
        print(f"serve {name}: card vs CPU server on seeds 0..{SERVE_SEEDS - 1}"
              f": actions equal {same}; logprob max abs diff {lp:.3e}")
        check(same, f"serve {name}: card actions differ from the CPU's")
        rows[name] = {"positions_differ": bad, "card_vs_cpu_actions": same,
                      "logprob_diff": lp}
    return rows


def _scale_serve(smi: str) -> dict:
    outs = _processes([["-m", "repro_torch.launch.serve", "--spec",
                        str(QUICKSTART), *SERVE_LOAD]],
                      "policy serving as typed", "scale")
    metrics = dict(re.findall(r"^(serve_\w+)=(\S+)$", outs[0], re.M))
    metrics = {k: float(v) for k, v in metrics.items()}
    check(metrics.get("serve_shed") == 0.0 and metrics["serve_qps"] > 0,
          f"serve launcher: {metrics}")
    print(f"scale: serving on {smi}: quickstart policy, {SERVE_LOAD}: p50 "
          f"{metrics['serve_p50_ms']:.3f} ms, p99 "
          f"{metrics['serve_p99_ms']:.3f} ms, {metrics['serve_qps']:.1f} "
          f"QPS, mean batch {metrics['serve_mean_batch']:.2f}")
    return {"launcher": metrics, "rows": _serve_rows()}


def _scale_pool(smi: str) -> dict:
    """(c): the pool launcher's solo check; pool.serve() against each
    tenant's solo server; aggregate env steps/s at max_concurrency 1 and
    2 with the Jain index."""
    from repro_torch import api
    from repro_torch.launch.pool import jain_index
    from repro_torch.serve.loadgen import reset_obs
    from repro_torch.serve.server import PolicyServer, obs_template
    _processes([["-m", "repro_torch.launch.pool", "--spec", str(POOL_A),
                 "--spec", str(POOL_B), "--digest", "--check-solo"]],
               "pool launcher", "scale")
    specs = [api.load(str(POOL_A)), api.load(str(POOL_B))]
    pool = api.Session.pool(specs, device="cuda")
    results = pool.run()
    server = pool.serve()
    same = {}
    try:
        for name in pool.tenants():
            s = pool._get(name).session
            obs = reset_obs(s.env, 4, 1)
            solo = PolicyServer(s.policy.apply, results[name].params,
                                obs_like=obs_template(s.env),
                                serve=s.spec.serve, seed=s.cfg.seed,
                                device="cuda").start()
            try:
                same[name] = all(
                    server.act(obs[i], seed=i, model=name, timeout=120)
                    == solo.act(obs[i], seed=i, timeout=120)
                    for i in range(4))
            finally:
                solo.stop()
    finally:
        server.stop()
    print(f"scale: pool.serve() answers as each tenant's solo server: {same}")
    check(all(same.values()), f"pool.serve: {same}")
    rates = {}
    for mc in (1, 2):
        pool = api.Session.pool(specs, max_concurrency=mc, device="cuda")
        t0 = time.perf_counter()
        res = pool.run()
        wall = time.perf_counter() - t0
        counts = pool.schedule_counts()
        jain = jain_index(counts[n] / pool._get(n).weight for n in res)
        rates[f"max_concurrency={mc}"] = {
            "sps": sum(r.steps for r in res.values()) / wall,
            "jain": jain}
    print(f"scale: pool rates on {smi} (pool_a + pool_b, "
          f"{specs[0].intervals} intervals each): aggregate env steps/s "
          + "; ".join(f"{k} {v['sps']:.1f} (Jain {v['jain']:.3f})"
                      for k, v in rates.items()))
    return {"serve_equal": same, "rates": rates}


def phase_scale() -> dict:
    """Data parallelism, serving and tenancy on the card (phase 9 of the
    docstring). The kernel launch counts are zeroed before and read
    after: these paths launch none of the port's kernels."""
    smi = nvidia_smi()
    t0 = time.perf_counter()
    zero_launches()
    res = {"sharded": _scale_sharded(smi), "serve": _scale_serve(smi),
           "pool": _scale_pool(smi)}
    launches = read_launches()
    print(f"scale: launches of the port's kernels on the sharded, serve and "
          f"pool paths {launches}")
    _expect(launches, {}, "sharded, serve and pool paths")
    print(f"scale: phase {time.perf_counter() - t0:.1f} s")
    print("scale: " + json.dumps(res))
    return res


# ------------------------------------------------------- LLM training
class _Tee:
    """A stdout stand-in that keeps the lines written (and prints them)."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s: str) -> int:
        self.text.append(s)
        return self.out.write(s)

    def flush(self) -> None:
        self.out.flush()


def _captured(fn, *args) -> list:
    """``fn(*args)``, its stdout printed and returned as lines."""
    import contextlib
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        fn(*args)
    return "".join(tee.text).splitlines()


def _free_cuda() -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _grad_case(name: str, call, inputs: list, label: str, gen) -> dict:
    """One kernel's backward on the card: gradients of sum(out * c) (c a
    fixed N(0, 1) cotangent per output) through the kernel route under
    ``.backward()`` and under ``torch.func.grad``, against autograd of the
    plain version; each input's gradient at GRAD_TOL of its dtype.
    ``call(*inputs, use_kernel=...)`` returns the output tuple."""
    idx = [i for i, x in enumerate(inputs) if x is not None]
    with torch.no_grad():
        outs = call(*inputs, use_kernel=False)
    cots = [torch.randn(o.shape, generator=gen, device="cuda")
            for o in outs]

    def loss(*xs, use_kernel):
        return sum((o.float() * c).sum()
                   for o, c in zip(call(*xs, use_kernel=use_kernel), cots))

    def autograd(use_kernel):
        xs = [None if x is None else x.detach().clone().requires_grad_()
              for x in inputs]
        loss(*xs, use_kernel=use_kernel).backward()
        return [xs[i].grad for i in idx]

    mods = kernel_modules()
    zero_launches()
    got = autograd(True)
    launched = read_launches()[name]
    tma = mods["lru_scan"].tma_launches
    got_f = torch.func.grad(
        lambda *xs: loss(*[xs[idx.index(i)] if i in idx else None
                           for i in range(len(inputs))], use_kernel=True),
        argnums=tuple(range(len(idx))))(*[inputs[i] for i in idx])
    want = autograd(False)
    torch.cuda.synchronize()
    # a case with any bf16 input or output is held at bf16's tolerance
    # throughout: the plain version rounds its bf16 outputs, and the
    # cotangents that pass through them, where the backward does not
    bf16 = any(t.dtype == torch.bfloat16 for t in [*outs, *(
        inputs[i] for i in idx)])
    tol = TRAIN_GRAD_TOL[torch.bfloat16 if bf16 else torch.float32]
    err, ok = 0.0, launched > 0
    for g, gf, w in zip(got, got_f, want):
        for x in (g, gf):
            err = max(err, (x.float() - w.float()).abs().max().item())
            ok = ok and x.dtype == w.dtype and bool(
                torch.isfinite(x).all()) and torch.allclose(
                x.float(), w.float(), atol=tol, rtol=tol)
    route = {"flash_attention": "kernel forward; backward the VJP of the "
                                "plain version",
             "wkv6": "kernel forward; backward the VJP of the chunked "
                     "plain version",
             "lru_scan": f"kernel forward and backward ({tma} of "
                         f"{launched} launches on the TMA kernel)"}[name]
    row = {"case": label, "launches": launched, "route": route,
           "max_abs_err": err, "tol": tol, "ok": ok}
    print(f"llm_train (a) {name} backward {label}: .backward() and "
          f"torch.func.grad vs autograd of the plain version max abs err "
          f"{err:.3e} (allclose at {tol}); {launched} launches under "
          f".backward(); route: "
          f"{route}; ok {ok}")
    check(ok, f"{name} backward {row}")
    return row


def _llm_backwards() -> dict:
    """(a): each kernel's backward against autograd of its plain version
    on the card: the reference grad tests' shapes, shapes off the block
    multiples, and the training shapes."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {"flash_attention": [], "lru_scan": [], "wkv6": []}
    for case in TRAIN_FLASH:
        B, S, H, KV, Dh, causal, window, cap, bq, bk, dt = case
        kw = dict(causal=causal, window=window, cap=cap, bq=bq, bk=bk)
        rows["flash_attention"].append(_grad_case(
            "flash_attention",
            lambda q, k, v, use_kernel: (fa_ops.attend(
                q, k, v, use_kernel=use_kernel, **kw),),
            flash_inputs(case, gen),
            f"(B={B} S={S} H={H} KV={KV} Dh={Dh} window={window} cap={cap}"
            f" {dt})", gen))
    for case, init in TRAIN_LRU:
        a, b, h0 = lru_inputs(case, gen)
        rows["lru_scan"].append(_grad_case(
            "lru_scan",
            lambda a_, b_, h_, use_kernel: lru_ops.scan(
                a_, b_, h_, use_kernel=use_kernel),
            [a, b, h0 if init else None],
            f"(B, S, D)={case[:3]} a {case[3]}, b "
            f"{case[4] if len(case) > 4 else case[3]}, h0 {init}, "
            "cotangent on y and h_last", gen))
    for case, decay in TRAIN_WKV:
        rows["wkv6"].append(_grad_case(
            "wkv6",
            lambda *x, use_kernel: wkv_ops.mix(*x, use_kernel=use_kernel),
            list(wkv_inputs(case, gen, decay)),
            f"(B, T, H, N)={case[:4]} {case[4]} w {decay}", gen))
    return rows


def _bwd_times() -> dict:
    """Each backward at its training shape: the kernel route's backward
    (autograd.grad through the ``Function``), the plain version's
    backward (autograd of its graph) and, for flash attention, SDPA's
    backward, with a bound for the backward's work."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.lru_scan.ref import lru_scan_ref
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}

    def timed(fn_kernel, fn_plain, inputs, iters=10, warmup=2):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        o_k = fn_kernel(*xs)
        o_p = fn_plain(*xs)
        cots = [torch.randn(o.shape, generator=gen, device="cuda").to(
            o.dtype) for o in o_k]
        k_ms = cuda_ms(lambda: torch.autograd.grad(
            o_k, xs, cots, retain_graph=True), iters, warmup)
        p_ms = cuda_ms(lambda: torch.autograd.grad(
            o_p, xs, cots, retain_graph=True), iters, warmup)
        return k_ms, p_ms, xs, cots

    # flash attention at StarCoder2's shape
    B, S, H, KV, Dh, causal, window, *_, dt = MAIN_TRAIN
    q, k, v = flash_inputs(MAIN_TRAIN, gen)
    k_ms, p_ms, _, _ = timed(
        lambda *x: (fa_ops.attend(*x, causal=True),),
        lambda *x: (fa_ops.attend(*x, causal=True, use_kernel=False),),
        [q, k, v])
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    try:
        o_s = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
    except TypeError:   # torch without enable_gqa
        o_s = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(H // KV, 1),
            vt.repeat_interleave(H // KV, 1), is_causal=True)
    g_s = torch.randn(o_s.shape, generator=gen, device="cuda").to(dt)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(o_s, (qt, kt, vt), g_s,
                                                 retain_graph=True))
    pairs = S * (S + 1) // 2
    # q, k, v, o and do read, dq, dk, dv written; 5 products of the
    # (query, key) pairs: S = q k^T again, dV, dP, dQ, dK
    bd = bound(nbytes(q, k, v, q, q, q, k, v), 10 * B * H * pairs * Dh, dt)
    out["flash_attention"] = {"shape": [B, S, H, KV, Dh], "ms": k_ms,
                              "plain_ms": p_ms, "library_ms": lib_ms, **bd}
    # lru_scan at RecurrentGemma's shape
    a, b, h0 = lru_inputs(LRU_TRAIN, gen)
    mods = kernel_modules()
    k_ms, p_ms, _, _ = timed(lambda *x: lru_ops.scan(*x),
                             lambda *x: lru_scan_ref(*x), [a, b, h0],
                             iters=5, warmup=1)
    # a, y, dy, h0, dh_last read; da, db, dh0 written; per element the
    # scan's multiply-add and the two products
    bd = bound(nbytes(a, a, a, h0, h0, a, a, h0), 4 * a.numel(),
               torch.float32)
    out["lru_scan"] = {"shape": list(a.shape), "ms": k_ms, "plain_ms": p_ms,
                       "library_ms": None, **bd}
    # wkv6 at RWKV-6's shape
    r, kk, vv, w, u, s0 = wkv_inputs(WKV_TRAIN, gen)
    k_ms, p_ms, _, _ = timed(lambda *x: wkv_ops.mix(*x),
                             lambda *x: wkv6_ref(*x), [r, kk, vv, w, u, s0],
                             iters=2, warmup=1)
    Bw, T, Hw, N, _ = WKV_TRAIN
    # inputs and both cotangents read, every input's gradient written;
    # the least FLOP counted as twice the forward's (each forward product
    # has two gradient products)
    bd = bound(2 * nbytes(r, kk, vv, w, u, s0) + nbytes(r, s0),
               2 * Bw * Hw * T * (5 * N * N + 5 * N), torch.float32)
    out["wkv6"] = {"shape": [Bw, T, Hw, N], "ms": k_ms, "plain_ms": p_ms,
                   "library_ms": None, **bd}
    del mods
    for name, row in out.items():
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"  {name} backward {row['shape']}: kernel route "
              f"{row['ms']:.4f} ms, plain version's backward "
              f"{row['plain_ms']:.4f} ms, library {lib}; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bytes']} bytes, {row['ops']} FLOP)")
    return out


def _memory_reckoning(cfg) -> dict:
    """The training state's bytes: params, params_prev and the gradients
    in each leaf's dtype, Adam's m and v in fp32."""
    from repro_torch.models import backbone
    leaves = list(backbone.Backbone(cfg, device="meta").parameters())
    n = sum(p.numel() for p in leaves)
    state = sum(p.numel() * (3 * p.element_size() + 8) for p in leaves)
    return {"params": n, "state_bytes": state}


def _llm_starcoder(smi: str) -> dict:
    """(b): ``python -m repro_torch.launch.train --arch starcoder2-3b
    --steps 3 --batch 4 --seq 512`` as typed (``main`` in this process, so
    the launch counts and the peak memory can be read)."""
    from unittest import mock

    from repro_torch.configs.base import get_config
    from repro_torch.core import stream_runtime
    from repro_torch.launch import train
    make_step = stream_runtime.learner.make_train_step
    stamps = []

    def timed_steps(*args, **kwargs):
        """The runtime's train step, time-stamped after each step (the
        launcher's observer reads every step's loss on the host, so each
        step ends synchronized already)."""
        step = make_step(*args, **kwargs)

        def timed(dg, batch):
            out = step(dg, batch)
            stamps.append((time.perf_counter(), float(out[1]["loss"])))
            return out
        return timed

    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(stream_runtime.learner, "make_train_step",
                           timed_steps):
        train.main(list(LLM_TRAIN))
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(len(stamps) == LLM_STEPS, f"starcoder2-3b ran {len(stamps)} steps")
    losses = [x for _, x in stamps]
    check(all(np.isfinite(losses)), f"starcoder2-3b losses {losses}")
    times = [t for t, _ in stamps]
    step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    tok_s = LLM_BATCH * LLM_SEQ * len(step_ms) / (times[-1] - times[0])
    cfg = get_config("starcoder2-3b")
    reck = _memory_reckoning(cfg)
    per_step = {k: v / LLM_STEPS for k, v in launches.items()}
    print(f"llm_train (b) {' '.join(LLM_TRAIN)} on {smi}: losses "
          f"{losses}; ms per step after the first {step_ms}; "
          f"{tok_s:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB (max_memory_allocated) against the "
          f"training state's {reck['state_bytes'] / 1e9:.2f} GB "
          f"({reck['params']:,} params: params, params_prev, grads in bf16,"
          f" Adam m and v fp32); launches {launches}, per step {per_step}; "
          f"{wall:.1f} s in all")
    _expect(launches, {"flash_attention": LLM_FLASH_PER_STEP * LLM_STEPS},
            "starcoder2-3b training")
    _free_cuda()
    return {"losses": losses, "step_ms": step_ms, "tokens_s": tok_s,
            "peak_bytes": peak, **reck, "launches": launches,
            "launches_per_step": per_step, "wall_s": wall}


def _train_grads(cfg, params, batch, use_kernel: bool):
    from repro_torch.core import learner
    cfg = dataclasses.replace(cfg, use_pallas_attention=use_kernel)
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    loss, _ = learner.rl_loss(leaves, cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


def _rel_l2(a: dict, b: dict) -> dict:
    return {n: ((a[n].float() - b[n].float()).norm()
                / b[n].float().norm().clamp_min(1e-30)).item() for n in b}


def _llm_spec_run(arch: str, smi: str, tmp: Path) -> dict:
    """(c): one family at full width with its depth cut, through
    ``python -m repro_torch.launch.run --spec``; then its first step's
    loss and gradients, kernels against plain versions on the card."""
    from repro_torch import api, models
    from repro_torch.launch import run
    n_layers, per_step = LLM_SPEC_RUNS[arch]
    kwargs = {"arch": arch, "n_layers": n_layers,
              "use_pallas_attention": True}
    policy = models.get_policy("backbone", None, **kwargs)
    cfg = policy.config
    spec = api.ExperimentSpec(
        env={"name": "token_stream", "kwargs": {
            "vocab": cfg.vocab_size, "batch": LLM_BATCH, "seq": LLM_SEQ}},
        policy={"name": "backbone", "kwargs": kwargs},
        optimizer={"name": "adam", "kwargs": {"lr": 1e-4}},
        algorithm="a2c", runtime={"name": "stream"},
        intervals=LLM_SPEC_STEPS)
    path = tmp / f"{arch}.json"
    api.save(spec, str(path))
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    lines = _captured(run.main, ["--spec", str(path), "--log-every", "1"])
    wall = time.perf_counter() - t0
    launches = read_launches()
    lru_tma = kernel_modules()["lru_scan"].tma_launches
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m.group(1)) for line in lines
              for m in [re.match(r"interval\s+\d+ loss (\S+)", line)] if m]
    check(len(losses) == LLM_SPEC_STEPS and all(np.isfinite(losses)),
          f"{arch} launcher losses {losses}")
    print(f"llm_train (c) {arch} n_layers={n_layers} d_model={cfg.d_model} "
          f"vocab={cfg.vocab_size} {cfg.dtype}, launch.run --spec, "
          f"{LLM_SPEC_STEPS} steps of {LLM_BATCH}x{LLM_SEQ} on {smi}: "
          f"losses {losses}; launches {launches} (per step "
          f"{ {k: v / LLM_SPEC_STEPS for k, v in launches.items()} }; "
          f"lru_scan on the TMA kernel {lru_tma}); peak memory "
          f"{peak / 1e9:.2f} GB; {wall:.1f} s")
    _expect(launches, {k: v * LLM_SPEC_STEPS for k, v in per_step.items()},
            f"{arch} training")
    check(lru_tma == launches["lru_scan"],
          f"{arch}: lru_scan launches off the TMA kernel")
    _free_cuda()
    first = {dtype: _first_step(arch, n_layers, dtype, tol)
             for dtype, tol in (("bfloat16", LLM_LOSS_TOL),
                                ("float32", CARD_CPU_LOSS_TOL))}
    return {"n_layers": n_layers, "losses": losses, "launches": launches,
            "lru_scan_tma": lru_tma, "peak_bytes": peak,
            "first_step": first, "wall_s": wall}


def _first_step(arch: str, n_layers: int, dtype: str,
                loss_tol: float) -> dict:
    """(c): the first step's loss and every gradient leaf on the card,
    kernels against plain versions, on the weights of seed 0 in
    ``dtype``. For RWKV-6 each leaf's distance is printed beside that of
    a witness with the kernel's own rounding: the kernel's ``Function``
    with its binding replaced by ``wkv6_chunked_ref``. The loss is held
    at ``loss_tol``; the leaves at LLM_GRAD_REL_L2[dtype][arch] where
    that is set."""
    from unittest import mock

    from repro_torch import models
    from repro_torch.core import determinism
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref
    policy = models.get_policy("backbone", None, arch=arch,
                               n_layers=n_layers, dtype=dtype,
                               use_pallas_attention=True)
    cfg = policy.config
    params = policy.init(determinism.master_key(0, device="cuda"))
    batch = {k: v.cuda() for k, v in TokenStream(
        cfg.vocab_size, LLM_BATCH, LLM_SEQ, 0).skip(1).next_batch().items()}
    loss_k, grads_k = _train_grads(cfg, params, batch, True)
    loss_p, grads_p = _train_grads(cfg, params, batch, False)
    rel = _rel_l2(grads_k, grads_p)
    del grads_k
    witness = {}
    if arch == "rwkv6-7b":
        with mock.patch.object(wkv_kernel, "wkv6", wkv6_chunked_ref):
            _, grads_w = _train_grads(cfg, params, batch, True)
        witness = _rel_l2(grads_w, grads_p)
        del grads_w
    del params, grads_p
    _free_cuda()
    bound = LLM_GRAD_REL_L2[dtype].get(arch)
    worst = max(rel, key=rel.get)
    print(f"llm_train (c) {arch} {dtype} first step, kernels vs plain "
          f"versions on the card (same weights): loss {loss_k:.6f} vs "
          f"{loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3e}, tol "
          f"{loss_tol}); gradient relative L2 distance per leaf"
          + (" (and, in brackets, the kernel's Function on "
             "wkv6_chunked_ref against the plain run)" if witness else "")
          + ": " + ", ".join(f"{n} {v:.3e}" + (f" [{witness[n]:.3e}]"
                                               if witness else "")
                             for n, v in rel.items())
          + f"; largest {worst} {rel[worst]:.3e} (bound "
          + (f"{bound:.0e})" if bound else "none: printed, see "
             "LLM_GRAD_REL_L2)"))
    check(abs(loss_k - loss_p) <= loss_tol
          and (bound is None or rel[worst] <= bound),
          f"{arch} {dtype}: first step kernels vs plain versions")
    return {"loss_kernel": loss_k, "loss_plain": loss_p,
            "grad_rel_l2_max": [worst, rel[worst]], "bound": bound,
            "witness_rel_l2_max": max(witness.values(), default=None)}


def _llm_resume(tmp: Path) -> dict:
    """(d): StarCoder2-3B at full width with 2 layers through the
    launcher: stopped at 2 and resumed to 4 equals an uninterrupted 4
    steps, every checkpoint leaf."""
    from repro_torch.launch import train
    base = ["--arch", "starcoder2-3b", "--n-layers", str(LLM_RESUME_LAYERS),
            "--batch", str(LLM_BATCH), "--seq", str(LLM_SEQ)]
    a, b = tmp / "resume_a", tmp / "resume_b"
    t0 = time.perf_counter()
    _free_cuda()
    train.main(base + ["--ckpt-dir", str(a), "--ckpt-every", "2",
                       "--steps", "2"])
    _free_cuda()
    train.main(base + ["--ckpt-dir", str(a), "--resume", "--steps", "4"])
    for f in a.glob("step_00000002.*"):
        f.unlink()
    _free_cuda()
    train.main(base + ["--ckpt-dir", str(b), "--steps", "4"])
    _free_cuda()
    got = np.load(a / "step_00000004.npz")
    want = np.load(b / "step_00000004.npz")
    same = sorted(got.files) == sorted(want.files)
    n_bytes = 0
    for key in want.files:
        x, y = got[key], want[key]
        same = same and x.dtype == y.dtype and np.array_equal(x, y)
        n_bytes += y.nbytes
    print(f"llm_train (d) starcoder2-3b, {LLM_RESUME_LAYERS} layers at full "
          f"width: --ckpt-every 2 --steps 2, then --resume --steps 4, "
          f"against --steps 4: {len(want.files)} checkpoint leaves "
          f"({n_bytes / 1e9:.2f} GB) equal {same}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(same, "starcoder2-3b resumed run differs from the straight run")
    return {"leaves": len(want.files), "bytes": n_bytes, "equal": same}


def _llm_card_vs_cpu() -> dict:
    """(e): each family's reduced config in fp32, 3 steps of the stream
    runtime on the card (kernels) and on the CPU (plain versions) from
    the same weights: SGD's losses and params, Adam's losses; and a
    rerun on the card, bit for bit."""
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import HTSConfig
    from repro_torch.core.stream_runtime import StreamRuntime
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import backbone
    rows = {}
    for arch in ("starcoder2-3b", "recurrentgemma-9b", "rwkv6-7b"):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", use_pallas_attention=True)
        model = backbone.init_params(cfg, torch.Generator().manual_seed(0),
                                     "cpu")
        params = {n: p.detach() for n, p in model.named_parameters()}
        row = {}
        for opt_name, kw in (("sgd", {"lr": 0.05}), ("adam", {"lr": 1e-3})):
            runs = {}
            for dev in ("cuda", "cpu", "cuda"):
                rt = StreamRuntime(
                    lambda: TokenStream(cfg.vocab_size, 2, 64, 0), params,
                    optim.get_optimizer(opt_name, **kw), HTSConfig(), cfg,
                    device=dev)
                zero_launches()
                out = rt.run(3)
                runs.setdefault(dev, []).append(
                    (out.metrics["loss"], rt.state().algo, read_launches()))
            (l_gpu, s_gpu, n_gpu), (_, s_again, _) = runs["cuda"]
            l_cpu, s_cpu, n_cpu = runs["cpu"][0]
            rerun = all(torch.equal(x, y) for x, y in zip(
                tree_leaves(s_gpu), tree_leaves(s_again)))
            loss_err = float(np.abs(l_gpu - l_cpu).max())
            par = max(((s_gpu.params[n] - s_cpu.params[n]).abs().max()
                       / s_cpu.params[n].abs().max().clamp_min(1e-30)).item()
                      for n in s_cpu.params)
            ok = (rerun and loss_err <= CARD_CPU_LOSS_TOL
                  and all(v > 0 for k, v in n_gpu.items()
                          if k in LLM_KERNELS[arch])
                  and (opt_name != "sgd" or par <= CARD_CPU_PARAMS_TOL))
            print(f"llm_train (e) {arch} reduced fp32, {opt_name}, 3 steps: "
                  f"card vs CPU losses max abs err {loss_err:.3e} (tol "
                  f"{CARD_CPU_LOSS_TOL}); params max err relative to each "
                  f"leaf's largest {par:.3e} ("
                  + (f"tol {CARD_CPU_PARAMS_TOL}" if opt_name == "sgd" else
                     "printed: Adam's first steps divide near-zero gradient "
                     "entries by their own size")
                  + f"); card rerun bit for bit {rerun}; card launches "
                  f"{n_gpu}")
            check(ok, f"{arch} {opt_name}: card vs CPU")
            row[opt_name] = {"loss_err": loss_err, "params_rel_err": par,
                             "rerun_equal": rerun, "launches": n_gpu}
        rows[arch] = row
    _free_cuda()
    return rows


def phase_llm_train() -> dict:
    """LLM-policy training on the card (phase 10 of the docstring)."""
    import tempfile
    smi = nvidia_smi()
    t0 = time.perf_counter()
    res = {"backward": _llm_backwards()}
    res["backward_times"] = _bwd_times()
    _free_cuda()
    res["starcoder2"] = _llm_starcoder(smi)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_llm_") as d:
        res["families"] = {arch: _llm_spec_run(arch, smi, Path(d))
                           for arch in LLM_SPEC_RUNS}
        res["resume"] = _llm_resume(Path(d))
    res["card_vs_cpu"] = _llm_card_vs_cpu()
    print(f"llm_train: phase {time.perf_counter() - t0:.1f} s")
    print("llm_train: " + json.dumps(res, default=str))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    seconds = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[label] = time.perf_counter() - t0
        print(f"phase {label}: {seconds[label]:.1f} s", flush=True)
        return out

    name = timed("card", phase_card)
    timed("build", phase_build)
    errs = timed("kernels", phase_kernels)
    runs = {arch: timed(f"serve {arch}", phase_serve, arch)
            for arch in SERVE_PATHS}
    timed("train", phase_train)
    timed("run", phase_run)
    timed("host", phase_host)
    timed("scale", phase_scale)
    llm = timed("llm_train", phase_llm_train)

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
    print("phase seconds: " + json.dumps(seconds))
    print(json.dumps({"kernels": [_entry(k, runs, errs[k], times[k], llm)
                                  for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
