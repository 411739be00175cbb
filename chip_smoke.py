"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. the card: nvidia-smi name and power limit, torch and CUDA versions;
2. the build: every hand-written kernel of the main paths
   (flash_attention, lru_scan, wkv6 and the backwards of all three), one
   nvcc per source, all started together, with each compiler report
   (registers, spills), the count of tensor-core instructions (HGMMA,
   HMMA) in each library's SASS and of TMA loads (UTMALDG) in both
   lru_scan libraries' and the flash backward's;
3. each kernel against its plain PyTorch version on the card, at the
   reference test cases, at shapes off the TPU kernels' block multiples
   and at the shapes the main paths give it; flash attention also on
   strided views in the model's layout (ragged S, window, soft-cap, every
   bf16 head dim, 120 and 160 among them, which the kernel runs at the
   padded widths 128 and 192; Dh 48 and 96 refused), at every serving
   path's prefill shape, at Sq != Sk (cross-attention, non-causal: one
   query and ragged query and key tiles, Whisper-medium's 500 and 1 decoder
   queries against its 1500 encoder frames, contiguous and as views of
   fused projections) and at Whisper's encoder (non-causal S 1500, a
   ragged last key tile) and Qwen2-VL's (64 / 8 heads, Dh 128) shapes,
   wkv6 also around its chunk length and with fast
   decay
   (w down to 1e-4, and w = 0), and the chunked wkv6 against its plain
   chunked form; lru_scan bit for bit (``torch.equal``) on both of its
   kernels, the TMA ring and the per-thread one (ragged tiles, and rows
   and bases that TMA refuses), each case printing the route it took;
4. the main paths, each through ``repro_torch.launch.serve.main`` at full
   width and full depth with random weights from seed 0, 4 prompts of 500
   tokens, 32 sampled (temperature 1, seed 3): StarCoder2-3B (flash attention in 30 layers),
   RecurrentGemma-9B (lru_scan in 26 RG-LRU layers, flash attention in 12
   local-attention layers), RWKV-6-7B (wkv6 in 32 layers, prefill and
   every decode step), Gemma-2-27B (flash in 46 layers), H2O-Danube3-4B
   (24, Dh 120), StableLM-2-12B (40, Dh 160), Granite-3.0-1B-a400m (24,
   MoE of 32 experts, top-8), Llama-4-Scout at ``--n-layers 4`` (4, MoE
   of 16 experts, top-1, a shared expert; its 48 layers do not fit one
   card), Whisper-medium (flash in its 24 encoder layers and its 24
   decoder layers' self- and cross-attention: 72 a prefill; the launcher
   runs the reference's stub inputs, zero audio at prefill and a zero
   ``enc_out`` at decode, and every comparison seeded audio frames with
   the encoder's output at each decode step) and Qwen2-VL-72B at
   ``--n-layers 8`` (19.0 GB; M-RoPE, seeded patch embeddings over the
   first 256 positions in the comparisons). The kernel launch counts are
   zeroed just before each run and
   read just after; then per prefill and per decode step. The prefill
   logits are held against the same weights run with the plain versions
   (for RWKV-6 beside the distance a reordering of the plain wkv6's sum
   alone makes), the launcher is run again to show its sampled tokens do
   not change, the full-width model in fp32 is held against its plain-version
   run (Gemma-2 at 2 layers: 46 take 82.4 GB in fp32; Qwen2-VL at 2,
   whose 8 take 38.0 GB, to keep the phase short), and a reduced fp32
   config is held against the CPU run of the same weights. For the MoE
   models each of these also compares every MoE layer's routing (printed;
   equal required card vs CPU) and checks that a group's padding rows
   chose experts 0..K-1. Each model is freed before the next;
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
   1e-5; ``examples/specs/quickstart.json`` (10 of its 40 intervals)
   runs twice on the card bit-identically, its host and device env
   backends give equal streams, and a K=2 run applies 10 updates; the
   device backend at n_envs 1024 (alpha 8, 10 intervals)
   gives env steps/s with a warm-up run excluded, and a profile window
   of 1 interval the device busy share and each stream's kernel time;
   the paper CNN at
   its published widths runs one ``actor_forward`` and one learner pass
   on a synthetic trajectory (alpha 5, n_envs 16, (84, 84, 4)), held
   against the port's CPU at 1e-4 relative, with times. Part ``fig5``
   drives the functional entry point ``core.mesh_runtime.train`` at
   ``tests/test_system.py``'s Fig. 5 setup (token env, vocab 32 x 8
   envs, alpha 8, 120 intervals) with HTS, sync A2C and 16-stale async,
   and prints the three tail rewards against the claims' thresholds
   (asserted on the CPU, not here: one seed's floats differ by device)
   with each run's seconds and env steps/s; at the quickstart
   configuration with n_envs 1024, ``train(n + 1)``'s params are
   ``torch.equal`` to ``MeshRuntime.run(n)``'s and a second ``train``
   call's. The path launches none of the port's kernels, and the counts
   say so;
7. the entry point (``phase_run``): ``python -m repro_torch.launch.run
   --spec examples/specs/quickstart.json`` with no other flag; then its
   ``main`` in this process with ``--ckpt-dir --ckpt-every 5 --intervals
   10`` and again with ``--resume --intervals 20``, whose last checkpoint (the reference's
   file format) equals an uninterrupted ``Session.fit(20)`` on the card:
   every capsule leaf ``torch.equal``, the episode-return stream equal; a
   fit under a fault plan (the checkpoint at 10 truncated, the segment
   from 10 failed once, ``max_restarts`` 2) recovers past the corrupt
   checkpoint to the fault-free fit's params and returns; gridmaze
   (``examples/specs/pool_b.json``: scenario 7, mlp, ppo, K=2; the same
   with the CPU tests' reduced CNN and with ``examples/atari_a2c.py``'s
   CNN) on the host and device env backends, card against the port's
   CPU (TF32 off): streams exact, params within 1e-5 (the atari_a2c CNN:
   its first learner pass's gradients within 1e-4 relative, its params'
   distance printed); the device-backend gridmaze at n_envs 1024, env
   steps/s over 2 runs after a warm-up; ``python -m repro_torch.launch.run
   --spec examples/specs/football_ppo.json --intervals 4`` (the
   mini-football drill, ppo, the threaded host runtime) and its first 4
   intervals card against CPU: streams exact, params within 1e-5. The
   launch counts of the port's kernels over all of that stay 0 (the
   kernels' backwards are held in phase 10 (a));
8. the threaded host runtime and the baselines (``phase_host``): (a)
   the launcher's ``main(["--spec", "examples/specs/quickstart.json",
   "--runtime", "host", ...])`` in this process, checkpointed and
   stopped at 10 and resumed to 20, whose last
   checkpoint equals the ``mesh`` runtime's ``Session.fit(20)`` leaf for
   leaf with the same episode-return stream; (b) host == mesh on the card
   (``torch.equal``) at K 1 and 2, with 1 and 4 actors, with and without
   the football spec's step-time model, and the card's host run against
   the port's CPU (streams exact, params within 1e-5); (c)
   ``examples/atari_a2c.py``'s contenders (mesh, sync, async with
   V-trace at k=8) and the host runtime, 6 intervals each on the card
   against the port's CPU: streams exact, the actions of interval 0 (at
   theta_0) exact, each one's first learner gradient within 1e-4
   relative per leaf; printed: the intervals whose actions differ later,
   the params' distance, beside the same for the CPU run from theta_0
   moved one ulp (what rounding alone does to this CNN under rmsprop),
   and tail rewards; then the host runtime's device memory after 15
   intervals within one parameter tree of that after 3; (d) an
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
   examples/specs/quickstart.json --intervals 10`` as two ranks on the
   one card (the default backend is then gloo, and the gradient sums
   travel through the host) and as one rank (nccl), the three processes
   started together: every rank's params digest equals the 1-process
   ``mesh`` run's; ``examples/atari_a2c.py``'s workload
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
   (its hand-written backward kernel; flash's from the lse its forward
   writes; lru_scan's also ``torch.equal`` to its plain version
   ``lru_scan_bwd_ref``) under ``.backward()`` and ``torch.func.grad``
   against autograd of the plain version on the card, at 1e-4 (fp32) and
   3e-2 (bf16), and ``.backward()`` twice on the same inputs for
   ``torch.equal`` gradients (no atomics): the reference grad tests'
   shapes, shapes off the block multiples, soft-cap, GQA, window, every
   bf16 head dim, fp32, Sq != Sk, ``kv_len`` through the bindings, every
   arch's attention at its training shape (each bf16 flash case also
   against an fp32 witness, ``ref.flash_attention_bwd_ref`` on fp32
   copies of its inputs: no further from it than the plain bf16 version,
   or within 3e-2 of it), lru_scan at S 1, 33 and a D
   that TMA refuses, h0 or none, a cotangent on h_last, mixed dtypes,
   wkv6 at T 1, 31, 32, 33, 512 with w = 0, N 8 and 16, fp32 fast decay
   (w down to 1e-4) at N 64 and RWKV-6's (4, 512, 64, 64), each printing
   its route and its backward-kernel launches (wkv6's backward binding
   also against its route's plain version, ``ref.wkv6_bwd_plain``, on
   the same inputs at every case, each output at its dtype's tolerance);
   each backward's time at its training shape against its
   plain version's, SDPA's backward (flash) and a bound, the flash
   backward kernel alone at every arch's training shape beside SDPA's
   backward wherever SDPA computes the same function, the bound and two
   earlier kernels' times (constants: PERF.md), the lru_scan
   backward kernel alone beside a same-traffic elementwise op, and the
   flash forward with and without its lse, and the wkv6 backward
   binding alone with its split by kernel (torch.profiler); (b) ``python -m
   repro_torch.launch.train --arch starcoder2-3b --steps 3 --batch 4
   --seq 512`` as typed (full width and depth: 30 layers, d_model 3072,
   bf16, Adam): finite losses, ms per step and tokens/s after the first
   step, peak memory beside the training state's reckoning, 60 flash
   forward and 30 backward launches per step; the same for
   Granite-3.0-1B-a400m (24 layers, 48 and 24 a step) with its
   load-balance loss nonzero; (c) RecurrentGemma-9B (3 layers) and
   RWKV-6-7B (2 layers) at full width through ``python -m
   repro_torch.launch.run --spec``, with their launches per step
   (lru_scan 4 and its backward 2, flash 2 and its backward 1; wkv6 4
   and its backward 2), then the first step's loss and every gradient leaf, kernels
   against plain versions on the card, in bf16 and in fp32: the loss at
   3e-2 (bf16) and 1e-4 (fp32), each leaf's relative L2 distance printed
   (RWKV-6's beside a witness with the kernel's rounding) and the
   largest held at ``LLM_GRAD_REL_L2`` (fp32 1e-3; bf16 5e-2 for
   RecurrentGemma, none for RWKV-6, whose bf16 gradient moves up to 1.2
   under any change of wkv6's rounding); the same first-step comparison
   for Gemma-2 and StableLM-2 at 2 layers and H2O-Danube3 and
   Granite-3.0-1B-a400m at 24, full width (leaves at 1e-3 in fp32 and
   5e-2 in bf16; Granite's bf16 leaves printed beside its routing, and
   its fp32 routing held: every row on the same experts and top-1); (d)
   StarCoder2-3B at full width with 1 layer: ``--ckpt-every 2 --steps
   2``, then ``--resume --steps 4``, equal to a straight ``--steps 4``
   in every checkpoint leaf; (e)
   each family's reduced config in fp32 (Granite with the capacity and
   the dropless dispatch, Llama-4 with its shared expert and NoPE global
   layer among them), 3 stream-runtime steps on the card and on the CPU
   from the same weights: losses within 1e-4, SGD's params within 1e-5
   of each leaf's largest entry, the MoE routing equal, and a rerun on
   the card bit for bit; (f) Whisper-medium at full width and depth, 3
   steps of ``make_train_step`` (Adam, bf16, 4 x 512 tokens and 4 x 1500
   audio frames; 120 flash launches a step), and Qwen2-VL-72B with Adam at
   2 layers (1 where 2 run out of memory; patch embeddings and three
   M-RoPE streams): ms per step, tokens/s, peak memory beside the state;
   first steps kernels vs plain of Whisper (24 layers) and Qwen2-VL (2)
   in (c)'s comparison, fp32 leaves at 1e-4; (g) ``blocked_attention``,
   the plain-PyTorch training route with its tiled backward, against
   ``attend_plain`` on the card (forward and gradients, time, memory),
   and one StarCoder2-3B first step at full width and depth through each
   route with its peak memory; (h) ``launch.train --arch h2o-danube-3-4b
   --steps 3`` with Adam at full depth (its peak, or the out-of-memory);
   (i) ``examples/torch_llm_policy_hts.py --intervals 4``;
11. the dry run (``phase_dryrun``): (a) ``python -m
   repro_torch.launch.dryrun`` for StarCoder2-3B train_4k and RWKV-6-7B
   decode_32k on the fake 256-rank pod world, each ``[OK]`` with its
   per-rank peak, ``fits_80g`` and bottleneck; (b) the world-1 dry run
   of (b)'s StarCoder2-3B step (30 layers, 4 x 512, Adam, bf16, kernels
   on) against one real step on the card: FLOPs within 0.1 % of
   ``op_cost``'s count of it, the predicted peak within 10 % of its
   ``max_memory_allocated``, the roofline's three terms beside the
   measured ms per step, and the MFU (``model_flops_for`` over ms x
   peak); (c) the stream runtime on a live 1-rank nccl mesh (2 steps,
   full width, 2 layers, the flash kernel under ``local_map``), its
   params ``torch.equal`` to the no-mesh run.

The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Needs CUDA; imports nothing of jax.
"""
from __future__ import annotations

import contextlib
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
    # head dims the bf16 kernel runs at a padded width (128, 192)
    (2, 128, 4, 2, 120, True, 0, 0.0, 64, 64, torch.bfloat16),
    (1, 130, 4, 1, 160, True, 0, 0.0, 128, 128, torch.bfloat16),
    (2, 96, 2, 2, 160, False, 0, 0.0, 32, 32, torch.bfloat16),
    # Sq != Sk (a twelfth element, Sk): cross-attention, non-causal, one
    # query and a ragged tile of queries against ragged key tiles, in both
    # dtypes; Whisper's one decode query against its 1500 encoder keys
    (2, 70, 4, 4, 64, False, 0, 0.0, 64, 64, torch.float32, 200),
    (2, 1, 4, 2, 64, False, 0, 0.0, 64, 64, torch.float32, 150),
    (2, 70, 4, 4, 64, False, 0, 0.0, 64, 64, torch.bfloat16, 200),
    (4, 1, 16, 16, 64, False, 0, 0.0, 128, 128, torch.bfloat16, 1500),
    (4, 1, 16, 16, 64, False, 0, 0.0, 128, 128, torch.float32, 1500),
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
    (2, 500, 8, 2, 120, True, 0, 0.0, 128, 128, torch.bfloat16),
    (1, 500, 4, 2, 120, True, 200, 30.0, 128, 128, torch.bfloat16),
    (2, 80, 4, 4, 120, False, 0, 0.0, 128, 128, torch.bfloat16),
    (2, 500, 4, 1, 160, True, 0, 50.0, 128, 128, torch.bfloat16),
    (1, 80, 4, 2, 160, True, 48, 20.0, 128, 128, torch.bfloat16),
]
MAIN = (4, 500, 24, 2, 128, True, 0, 0.0, 128, 128, torch.bfloat16)
# RecurrentGemma-9B's local attention: MQA, Dh=256, window 2048
RG_ATTN = (4, 500, 16, 1, 256, True, 2048, 0.0, 128, 128, torch.bfloat16)
# the prefill shapes of the decoders of the MoE slice: H2O-Danube3 (Dh 120,
# its window 4096 wider than the prompt), StableLM-2 (Dh 160), Gemma-2
# (soft-cap 50, its local layers' window 4096), Granite-3.0-1B-a400m and
# Llama-4-Scout (its global layers; the local ones' 8192 window masks
# nothing more at S 500)
DANUBE_ATTN = (4, 500, 32, 8, 120, True, 4096, 0.0, 128, 128, torch.bfloat16)
STABLELM_ATTN = (4, 500, 32, 8, 160, True, 0, 0.0, 128, 128, torch.bfloat16)
GEMMA_ATTN = (4, 500, 32, 16, 128, True, 4096, 50.0, 128, 128, torch.bfloat16)
GRANITE_ATTN = (4, 500, 16, 8, 64, True, 0, 0.0, 128, 128, torch.bfloat16)
LLAMA4_ATTN = (4, 500, 40, 8, 128, True, 0, 0.0, 128, 128, torch.bfloat16)
# the shapes of the encoder-decoder and VLM slice. A twelfth element is the
# key length Sk where it differs from the query length: Whisper-medium's
# encoder (non-causal, S 1500: 1500 = 11 * 128 + 92, a ragged last key
# tile), its cross-attention prefill (the decoder's 500 queries against
# the encoder's 1500 keys, non-causal), its decoder self-attention (MHA
# 16 / 16, Dh 64) and Qwen2-VL-72B's (64 / 8 heads, Dh 128)
WHISPER_ENC_ATTN = (4, 1500, 16, 16, 64, False, 0, 0.0, 128, 128,
                    torch.bfloat16)
WHISPER_CROSS_ATTN = (4, 500, 16, 16, 64, False, 0, 0.0, 128, 128,
                      torch.bfloat16, 1500)
WHISPER_SELF_ATTN = (4, 500, 16, 16, 64, True, 0, 0.0, 128, 128,
                     torch.bfloat16)
QWEN_ATTN = (4, 500, 64, 8, 128, True, 0, 0.0, 128, 128, torch.bfloat16)
PREFILL_ATTN = [MAIN, RG_ATTN, DANUBE_ATTN, STABLELM_ATTN, GEMMA_ATTN,
                GRANITE_ATTN, LLAMA4_ATTN, WHISPER_ENC_ATTN,
                WHISPER_CROSS_ATTN, WHISPER_SELF_ATTN, QWEN_ATTN]
# the slice's shapes as views too: q a slice of a wider projection, k and
# v of one fused (B, Sk, 2 KV, Dh) encoder projection; and the cross
# shape in fp32
FLASH_STRIDED += [WHISPER_ENC_ATTN, WHISPER_CROSS_ATTN, QWEN_ATTN,
                  (4, 500, 16, 16, 64, False, 0, 0.0, 128, 128,
                   torch.float32, 1500)]
# bf16 head dims the tensor-core kernel has no form for: refused, no fallback
FLASH_REFUSED = (48, 96)

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
# the launcher's sampling, so that its run is also the first of the two
# that must give the same tokens; the second, warm, is the path's timed
# steady-state run
SAMPLE_ARGS = ("--temperature", "1.0", "--seed", "3")
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
    # the backwards replace the reference's custom_vjp, which
    # differentiates its oracle (no Pallas backward)
    "flash_attention_bwd": ("src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/ops.py:41"),
    "wkv6_bwd": ("src/repro_torch/kernels/wkv6/csrc/wkv6_bwd.cu",
                 "src/repro/kernels/wkv6/ops.py:31"),
    # the reference's analytic backward: the forward kernel on reversed
    # time (no Pallas backward of its own)
    "lru_scan_bwd": ("src/repro_torch/kernels/lru_scan/csrc/lru_scan_bwd.cu",
                     "src/repro/kernels/lru_scan/ops.py:36"),
}
# kernel -> (its module in kernel_modules(), its launch counter there)
COUNTERS = {"flash_attention": ("flash_attention", "launches"),
            "lru_scan": ("lru_scan", "launches"),
            "wkv6": ("wkv6", "launches"),
            "flash_attention_bwd": ("flash_attention", "bwd_launches"),
            "wkv6_bwd": ("wkv6", "bwd_launches"),
            "lru_scan_bwd": ("lru_scan", "bwd_launches")}

# kernels whose libraries must hold tensor-core instructions, and those
# that must hold TMA loads
TENSOR_CORE_KERNELS = ("flash_attention", "wkv6", "flash_attention_bwd",
                       "wkv6_bwd")
TMA_KERNELS = ("lru_scan", "lru_scan_bwd", "flash_attention_bwd")

# arch -> launches expected (in serve.main: prefill + GEN-1 decode steps,
# per prefill, per decode step); kernels not named must launch 0 times.
# Decode attention is plain in the reference and here: flash runs once
# per attention layer and prefill
SERVE_PATHS = {
    "starcoder2-3b": ({"flash_attention": 30}, {"flash_attention": 30}, {}),
    "recurrentgemma-9b": ({"flash_attention": 12, "lru_scan": 26},
                          {"flash_attention": 12, "lru_scan": 26}, {}),
    "rwkv6-7b": ({"wkv6": 32 + (GEN - 1) * 32}, {"wkv6": 32}, {"wkv6": 32}),
    "gemma2-27b": ({"flash_attention": 46}, {"flash_attention": 46}, {}),
    "h2o-danube-3-4b": ({"flash_attention": 24}, {"flash_attention": 24},
                        {}),
    "stablelm-12b": ({"flash_attention": 40}, {"flash_attention": 40}, {}),
    "granite-moe-1b-a400m": ({"flash_attention": 24},
                             {"flash_attention": 24}, {}),
    "llama4-scout-17b-a16e": ({"flash_attention": 4},
                              {"flash_attention": 4}, {}),
    # the encoder's 24 layers, the decoder's 24 self- and 24
    # cross-attention layers, once per prefill; decode attends to the
    # cache and to the encoder states without the kernel
    "whisper-medium": ({"flash_attention": 72}, {"flash_attention": 72},
                       {}),
    "qwen2-vl-72b": ({"flash_attention": 8}, {"flash_attention": 8}, {}),
}
# the launcher's extra flags per arch: Llama-4-Scout's 48 layers (215.6 GB
# in bf16) do not fit one card; 4 layers, one iRoPE cycle, do. Qwen2-VL's
# 80 layers take 145.4 GB; 8 take 19.0 GB
SERVE_ARGS = {"llama4-scout-17b-a16e": ("--n-layers", "4"),
              "qwen2-vl-72b": ("--n-layers", "8")}
# the fp32 full-width check's depth where the full depth does not fit:
# Gemma-2's 46 layers take 82.4 GB in fp32; 2, one local/global cycle.
# Qwen2-VL at 2 layers (17.0 GB), where its served 8 would take 38.0 GB:
# the check's time, not the card, sets that depth
FP32_LAYERS = {"gemma2-27b": 2, "qwen2-vl-72b": 2}
# the modality inputs of the comparisons (the launcher as typed runs the
# reference's stub: zero audio and patches, a zero enc_out at decode):
# seeded N(0, 1) audio frames and patch embeddings, the encoder's output
# of the audio at every decode step
MODAL_SEED = 5


# the training phase: the goldens' configuration (tests/test_goldens.py)
TRAIN_ALGORITHMS = ("a2c", "ppo", "vtrace")
GOLDEN = dict(alpha=4, n_envs=4, seed=3)
GOLDEN_INTERVALS = 3
PARAMS_TOL = 1e-5            # card vs CPU, the goldens' final params
QUICKSTART = ROOT / "examples" / "specs" / "quickstart.json"
# the quickstart spec's runs here and the distributed launcher's: a
# quarter of its 40 intervals, to keep the whole script inside its time
# limit
QUICKSTART_INTERVALS = DISTRIBUTED_INTERVALS = 10
SCALE = dict(alpha=8, n_envs=1024, intervals=10)
# timed runs after a warm-up run at that scale
TIMED_RUNS = 2
# the profiled window at that scale (about 14,000 kernels an interval)
PROFILE_INTERVALS = 1
CNN_TRAJ = dict(alpha=5, n_envs=16)
CNN_REL_TOL = 1e-4           # card vs CPU, paper CNN at fp32, TF32 off
# tests/test_system.py's Fig. 5 setup (token env, token policy, rmsprop)
# and its claims' tail (the last quarter of the intervals); the
# functional entry point's unconsumed trajectory at the quickstart
# configuration, n_envs 1024, train(n + 1) against MeshRuntime.run(n)
FIG5 = dict(vocab=32, n_envs=8, alpha=8, hidden=64, lr=5e-3,
            entropy_coef=0.003, intervals=120, tail=0.25)
FIG5_STALE = dict(staleness=16, correction="none")
FIG5_UNCONSUMED = dict(n_envs=1024, intervals=3)

# the entry point: launcher segments (stop at RUN_STOP, resume to
# RUN_TOTAL, a checkpoint every RUN_EVERY), the fault plan's truncated
# checkpoint and failed segment, gridmaze cells
# (short, to keep the whole script inside its time limit)
RUN_STOP, RUN_TOTAL, RUN_EVERY = 10, 20, 5
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
# the football spec's launcher run (4 of its 40 intervals: the threaded
# host runtime with the spec's step-time model takes 44.6 s for 40 on an
# H100) and its intervals held card vs CPU
FOOTBALL_LAUNCH_INTERVALS = FOOTBALL_INTERVALS = 4

# the host runtime and the baselines (phase_host): intervals of the
# host == mesh cells; the football spec's step-time model (shape 1, rate
# 1, time_scale 0.002) on catch; examples/atari_a2c.py's contenders
# (gridmaze, its CNN, rmsprop, alpha 5, n_envs 8) and the host runtime as
# a fourth, with their interval count; the rate runs' intervals; the
# pipeline runs' intervals
HOST_N = 3
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
# 6 intervals keep the whole script inside its time limit
ATARI_INTERVALS = 6
MEM_SHORT, MEM_LONG = 3, 15          # host runtime's memory, intervals
RATE_INTERVALS = 6
RATE_RUNS = 1                        # timed runs after a warm-up
PIPE_INTERVALS = 4

# data parallelism, serving and tenancy (phase_scale): the sharded CNN
# runs' intervals (a capsule handed over at half of them); the serving
# launcher's load; the card-vs-CPU serving seeds
SHARD_INTERVALS = 6
SERVE_LOAD = ("--requests", "500", "--rate", "2000")
SERVE_SEEDS = 16
POOL_A = ROOT / "examples" / "specs" / "pool_a.json"

# LLM-policy training (phase_llm_train). (a): each kernel's backward
# against autograd of its plain version, at tests/test_kernels.py's
# tolerances, and run twice for equal gradients (the backward kernels use
# no atomics): flash at the reference grad test's case, off the blocks,
# soft-capped, GQA, every bf16 Dh, fp32, and every arch's attention at its
# training shape (B 4, S 512; Whisper's encoder at its 1500 frames, its
# cross-attention 512 against 1500), and ``kv_len`` through the bindings
# (FLASH_KV_LEN); lru_scan at the reference
# grad test's shape with and without h0, off the blocks, in bf16, with
# mixed dtypes and at RecurrentGemma's (4, 512, 4096); wkv6 at T 1, 31,
# 32, 33, 512 with a tenth of w = 0, and at RWKV-6's (4, 512, 64, 64).
# lru_scan's backward kernel also against its plain version, bit for bit:
# at S 1 and 33 (one step; a ragged last tile) and at D 45 (180-byte rows,
# which TMA refuses: the per-thread kernel)
TRAIN_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
MAIN_TRAIN = (4, 512, 24, 2, 128, True, 0, 0.0, 128, 128, torch.bfloat16)
RG_TRAIN = (4, 512, 16, 1, 256, True, 2048, 0.0, 128, 128, torch.bfloat16)
GRANITE_TRAIN = (4, 512, 16, 8, 64, True, 0, 0.0, 128, 128, torch.bfloat16)
TRAIN_FLASH = [
    (2, 48, 4, 2, 16, True, 16, 0.0, 32, 32, torch.float32),
    (1, 80, 2, 1, 16, True, 32, 0.0, 16, 16, torch.bfloat16),
    (1, 80, 2, 1, 16, True, 32, 0.0, 32, 32, torch.float32),
    (1, 96, 4, 4, 32, True, 0, 50.0, 32, 32, torch.float32),
    (2, 192, 4, 2, 256, False, 0, 0.0, 128, 128, torch.bfloat16),
    (2, 80, 4, 2, 120, True, 32, 30.0, 128, 128, torch.bfloat16),
    (1, 96, 4, 1, 160, True, 0, 0.0, 128, 128, torch.bfloat16),
    (2, 100, 4, 2, 32, True, 0, 0.0, 128, 128, torch.bfloat16),
    (2, 70, 4, 4, 200, False, 0, 0.0, 128, 128, torch.float32, 150),
] + [c if c is WHISPER_ENC_ATTN else (4, 512) + c[2:] for c in PREFILL_ATTN]
# (B, Sq, Sk, H, KV, Dh, causal, dtype, kv_len): the bindings with a
# kv_len mask (the model passes none; the wrapper's padding did), held
# against autograd of the plain forward
FLASH_KV_LEN = [(2, 130, 130, 4, 2, 64, True, torch.bfloat16, 97),
                (2, 70, 150, 4, 4, 128, False, torch.bfloat16, 101),
                (2, 70, 150, 4, 2, 96, False, torch.float32, 33)]
LRU_TRAIN = (4, 512, 4096, torch.float32)
TRAIN_LRU = [((2, 32, 8, torch.float32), True),
             ((2, 32, 8, torch.float32), False),
             ((2, 50, 48, torch.float32), True),
             ((3, 300, 600, torch.bfloat16), True),
             ((2, 70, 136, torch.float32, torch.bfloat16), True),
             ((2, 70, 136, torch.bfloat16, torch.float32), False),
             ((2, 1, 136, torch.float32), True),
             ((2, 33, 200, torch.float32), False),
             ((2, 50, 45, torch.float32), True),
             (LRU_TRAIN, False)]
WKV_TRAIN = (4, 512, 64, 64, torch.bfloat16)
TRAIN_WKV = [((2, T, 4, 64, torch.float32), "zero")
             for T in (1, 31, 32, 33, 512)] + [
    ((2, 100, 4, 16, torch.bfloat16), "fast"),
    ((2, 100, 4, 64, torch.float32), "fast"),
    ((2, 70, 4, 8, torch.float32), "zero"), (WKV_TRAIN, "reference")]
# (b): the main path as a user types it; its flash launches per step (30
# layers, forward and the checkpointed layer's recompute)
LLM_STEPS, LLM_BATCH, LLM_SEQ = 3, 4, 512
# arch -> flash launches per step, at full width and depth: StarCoder2-3B's
# 30 layers and Granite-3.0-1B-a400m's 24 (the MoE slice's main path)
LLM_TRAIN = {"starcoder2-3b": 60, "granite-moe-1b-a400m": 48}
# (c): the other families at full width, depth cut: arch -> (n_layers,
# launches per step). RecurrentGemma's one (rglru, rglru, local) cycle:
# lru_scan forward, recompute and backward in 2 layers, flash forward
# and recompute in 1 and its backward kernel; RWKV-6: wkv6 forward and
# recompute in 2 layers, and its backward kernel in each
LLM_SPEC_RUNS = {"recurrentgemma-9b": (3, {"lru_scan": 4, "lru_scan_bwd": 2,
                                           "flash_attention": 2,
                                           "flash_attention_bwd": 1}),
                 "rwkv6-7b": (2, {"wkv6": 4, "wkv6_bwd": 2})}
LLM_SPEC_STEPS = 2
LLM_LOSS_TOL = 3e-2      # bf16, kernels vs plain versions, first step
# (c) the largest per-leaf relative L2 gradient distance, kernels vs
# plain versions, by dtype and family, read over seeds by
# ``scripts/llm_grad_spread.py`` on an NVIDIA H100 80GB HBM3 at 700 W.
# In fp32 the kernels' largest over 18 RWKV-6 seeds is 4.9e-4, over the
# 5 of 6 Granite seeds whose routing agrees 2.1e-6 (on the sixth 2 of
# 98,304 routed rows chose other experts and a leaf moved 5.8e-3). In
# bf16 the largest over 6 seeds is 7.6e-3 (RecurrentGemma), 9.9e-3
# (Gemma-2), 1.1e-2 (StableLM-2) and 4.2e-2 (Danube3, 24 layers: a deep
# layer's key projection, whose gradient is small at random weights).
# RWKV-6's bf16 gradient is not bounded, only printed: there any change
# of wkv6's rounding, the kernel's or a plain witness's, moves a leaf
# 4e-4 to 1.2 by seed (its recurrence turns a flipped bf16 bit into a
# large gradient change on some inputs); nor is Granite's, where 13 % of
# the routed rows choose other experts in bf16 (its leaves move 0.19 to
# 0.22)
LLM_GRAD_REL_L2 = {"bfloat16": {"recurrentgemma-9b": 5e-2,
                                "gemma2-27b": 5e-2, "stablelm-12b": 5e-2,
                                "h2o-danube-3-4b": 5e-2},
                   "float32": {"recurrentgemma-9b": 1e-3,
                               "rwkv6-7b": 1e-3, "gemma2-27b": 1e-3,
                               "stablelm-12b": 1e-3,
                               "h2o-danube-3-4b": 1e-3,
                               "granite-moe-1b-a400m": 1e-3,
                               "whisper-medium": 1e-4,
                               "qwen2-vl-72b": 1e-4}}
# (c'): the decoders of the MoE slice at full width, depth cut: arch ->
# n_layers. Gemma-2 and StableLM-2 one cycle; H2O-Danube3 at its full 24
# (fp32 params and two gradient trees: 47.5 GB); Granite-3.0-1B-a400m at
# its full 24, its fp32 leaves bounded where its routing agrees (every
# row on the same experts, the same top-1)
LLM_FIRST_STEP = {"gemma2-27b": 2, "stablelm-12b": 2, "h2o-danube-3-4b": 24,
                  "granite-moe-1b-a400m": 24, "whisper-medium": 24,
                  "qwen2-vl-72b": 2}
# (d): StarCoder2-3B at full width with its depth cut for the resume
LLM_RESUME_LAYERS = 1
FLASH_BOTH = ("flash_attention", "flash_attention_bwd")
# (e): reduced fp32 configs, card vs CPU over 3 steps: label -> (arch,
# config overrides, the kernels it must launch); the MoE archs with their
# routing held equal
LLM_CARD_CPU = {
    "starcoder2-3b": ("starcoder2-3b", {}, FLASH_BOTH),
    "recurrentgemma-9b": ("recurrentgemma-9b", {},
                          ("lru_scan", "lru_scan_bwd") + FLASH_BOTH),
    "rwkv6-7b": ("rwkv6-7b", {}, ("wkv6", "wkv6_bwd")),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, FLASH_BOTH),
    "granite-moe-1b-a400m dropless": ("granite-moe-1b-a400m",
                                      {"moe_impl": "dropless"}, FLASH_BOTH),
    "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", {}, FLASH_BOTH),
}
CARD_CPU_LOSS_TOL = 1e-4
CARD_CPU_PARAMS_TOL = 1e-5
# (f): the encoder-decoder and the VLM. Whisper-medium at full width and
# depth, LLM_STEPS steps of ``make_train_step`` with Adam in bf16 on
# LLM_BATCH x LLM_SEQ tokens and LLM_BATCH x 1500 audio frames; its flash
# launches per step: the encoder's 24 layers once (the reference does not
# checkpoint its encoder) and the decoder's 24 self- and 24
# cross-attention layers in the forward and again in each checkpointed
# layer's recompute. Qwen2-VL-72B at full width with Adam at
# QWEN_TRAIN_LAYERS layers (4.25 B params, 59.5 GB of state), one layer
# if that runs out of memory; 2 flash launches a layer a step
WHISPER_TRAIN_FLASH = 24 + 2 * (24 + 24)
WHISPER_TRAIN_FLASH_BWD = 24 + 24 + 24   # the backward once a layer
QWEN_TRAIN_LAYERS = 2
# (g): blocked_attention (the plain-PyTorch training route with its tiled
# backward) against attend_plain on the card, forward and gradients, at
# StarCoder2-3B's and Whisper-medium's training shapes in bf16 and at a
# ragged Sq != Sk in fp32; then one StarCoder2-3B first step at full width
# and depth through each route, with its peak memory
BLOCKED_CASES = [MAIN_TRAIN,
                 (4, 1500, 16, 16, 64, False, 0, 0.0, 128, 128,
                  torch.bfloat16),
                 (4, 512, 16, 16, 64, False, 0, 0.0, 128, 128,
                  torch.bfloat16, 1500),
                 (2, 300, 8, 2, 64, True, 100, 30.0, 128, 128,
                  torch.float32),
                 (2, 200, 4, 4, 64, False, 0, 0.0, 128, 128, torch.float32,
                  700)]
# (h): H2O-Danube3-4B through ``launch.train`` with Adam at full depth
# (55.5 GB of state by the reckoning): its peak, or the out-of-memory
DANUBE_ADAM = "h2o-danube-3-4b"
# (i): ``examples/torch_llm_policy_hts.py`` as typed, for a few intervals
EXAMPLE_INTERVALS = 4


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def laps(tag: str):
    """A function that prints, under ``tag``, the seconds since its last
    call (the first: since ``laps``): a phase's parts where they are
    stretches of one function."""
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        print(f"{tag}: part {name}: {now - last[0]:.1f} s", flush=True)
        last[0] = now
    return lap


def part(tag: str, name: str, fn, *args):
    """``fn(*args)``, its seconds printed under the phase's tag: where the
    script's time limit goes, part by part."""
    lap = laps(tag)
    out = fn(*args)
    lap(name)
    return out


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


def kernel_libraries() -> dict:
    """kernel -> the function that builds and loads its library."""
    mods = kernel_modules()
    return {name: getattr(mods[mod], "bwd_library" if attr == "bwd_launches"
                          else "library")
            for name, (mod, attr) in COUNTERS.items()}


def zero_launches() -> None:
    mods = kernel_modules()
    for mod, attr in COUNTERS.values():
        setattr(mods[mod], attr, 0)
    mods["lru_scan"].tma_launches = 0
    mods["lru_scan"].bwd_tma_launches = 0


def read_launches() -> dict:
    torch.cuda.synchronize()
    mods = kernel_modules()
    return {name: getattr(mods[mod], attr)
            for name, (mod, attr) in COUNTERS.items()}


def cuda_ms(fn, iters: int = 20, warmup: int = 3,
            spin: int = 10_000_000) -> float:
    """Device time per call. A spin kernel of ``spin`` cycles (~5 ms by
    default) is queued first, so the host enqueues the timed calls while
    the card is busy: a kernel shorter than its wrapper's Python overhead
    is timed on the device, not at the host's launch rate, as long as the
    spin outlasts the host's enqueueing of all ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(spin)
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
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {n: sum(ts) for n, ts in kernel_events(prof).items()}
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


def kernel_events(prof) -> dict:
    """Each kernel's device times (us) in a torch.profiler profile, by
    kernel name. The runtime's profiler ranges (hts.*) show on the device
    side too; they are not kernels and are left out."""
    from torch.autograd import DeviceType
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.name.startswith("hts."):
            out.setdefault(e.name, []).append(e.device_time_total)
    return out


def kernel_split(fn) -> dict:
    """Device microseconds a launch of each kernel ``fn`` launches once a
    call, by kernel name (without namespace or template arguments): the
    mean over the kernel events torch.profiler kept of 50 calls after one
    warm-up call; {} where it kept none (not measured). Late in a long
    process the profiler keeps fewer of a short window's kernel events,
    more so as the process ages; so the window is long, idle for 0.1 s at
    each end, and a kernel's time is the mean of the events kept, not
    their sum over the calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.1)
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
    by_name: dict = {}
    for name, ts in kernel_events(prof).items():
        m = re.search(r"(\w+)[<(]", name)
        by_name.setdefault(m.group(1) if m else name, []).extend(ts)
    return {n: sum(ts) / len(ts) for n, ts in by_name.items()}


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
def key_len(case) -> int:
    """A flash case's key length: its twelfth element where it has one,
    else its query length."""
    return case[11] if len(case) > 11 else case[1]


def flash_inputs(case, gen, fused: bool = False):
    """q, k, v ~ N(0, 1) in the model's layout; ``fused``: as strided
    views into one (B, S, H + 2 KV, Dh) tensor, as a fused projection
    would give them (where Sk != Sq: q a view of a (B, Sq, 2 H, Dh)
    tensor, k and v of one (B, Sk, 2 KV, Dh) tensor)."""
    B, S, H, KV, Dh = case[:5]
    dt, Sk = case[10], key_len(case)
    if fused and Sk == S:
        qkv = torch.randn((B, S, H + 2 * KV, Dh), generator=gen,
                          device="cuda").to(dt)
        return qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    if fused:
        qq = torch.randn((B, S, 2 * H, Dh), generator=gen,
                         device="cuda").to(dt)
        kv = torch.randn((B, Sk, 2 * KV, Dh), generator=gen,
                         device="cuda").to(dt)
        return qq[:, :, :H], kv[:, :, :KV], kv[:, :, KV:]
    return [torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((B, S, H, Dh), (B, Sk, KV, Dh), (B, Sk, KV, Dh))]


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
    """One nvcc per source, all started together; then each library's
    SASS read, all together too."""
    def build(item):
        name, load = item
        t0 = time.perf_counter()
        lib = load()
        path = Path(lib._name)
        return (name, time.perf_counter() - t0, path,
                sass_count(path, "HGMMA|HMMA"),
                sass_count(path, "UTMALDG") if name in TMA_KERNELS else None)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(build, kernel_libraries().items()))
    print(f"build: {len(built)} libraries in "
          f"{time.perf_counter() - t0:.1f}s (in parallel)")
    for name, secs, path, _, _ in built:
        print(f"build: {Path(SOURCES[name][0]).name} by nvcc for sm_90a in "
              f"{secs:.1f}s -> {path.name}")
        log = path.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())
    for name, _, path, n_mma, n_tma in built:
        print(f"sass: {path.name}: {n_mma} tensor-core instructions "
              "(cuobjdump -sass | grep -cE 'HGMMA|HMMA')")
        if name in TENSOR_CORE_KERNELS:
            check(n_mma > 0, f"{name}: no HGMMA/HMMA in its SASS")
        if name in TMA_KERNELS:
            print(f"sass: {path.name}: {n_tma} TMA loads (cuobjdump -sass | "
                  "grep -c UTMALDG)")
            check(n_tma > 0, f"{name}: no UTMALDG in its SASS")


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
    for case in FLASH_CASES + PREFILL_ATTN:
        B, S, H, KV, Dh, causal, window, cap, bq, bk, dt = case[:11]
        q, k, v = flash_inputs(case, gen)
        kw = dict(causal=causal, window=window, cap=cap, bq=bq, bk=bk)
        out = fa_ops.attend(q, k, v, use_kernel=True, **kw)
        ref = fa_ops.attend(q, k, v, use_kernel=False, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = (out.shape == ref.shape and out.dtype == dt
              and bool(torch.isfinite(out).all()) and err <= TOL[dt])
        cases.append({"shape": [B, S, H, KV, Dh], "sk": key_len(case),
                      "causal": causal, "window": window, "cap": cap,
                      "dtype": str(dt), "max_abs_err": err, "tol": TOL[dt],
                      "ok": ok})
        check(ok, f"flash_attention {cases[-1]}")
        if case in PREFILL_ATTN:
            main_err = max(main_err, err)
    for case in FLASH_STRIDED:
        B, S, H, KV, Dh, causal, window, cap, bq, bk, dt = case[:11]
        q, k, v = flash_inputs(case, gen, fused=True)
        check(not q.is_contiguous(), "strided case: q is a strided view")
        kw = dict(causal=causal, window=window, cap=cap)
        out = fa_ops.attend(q, k, v, use_kernel=True, **kw)
        ref = fa_ops.attend(q, k, v, use_kernel=False, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = (out.shape == ref.shape and out.dtype == dt
              and bool(torch.isfinite(out).all()) and err <= TOL[dt])
        cases.append({"shape": [B, S, H, KV, Dh], "sk": key_len(case),
                      "causal": causal, "window": window, "cap": cap,
                      "dtype": str(dt),
                      "layout": "strided views of fused projections",
                      "max_abs_err": err, "tol": TOL[dt], "ok": ok})
        check(ok, f"flash_attention {cases[-1]}")
    for c in cases:
        if c["sk"] != c["shape"][1]:
            print(f"flash_attention Sq {c['shape'][1]} != Sk {c['sk']} "
                  f"(B, H, KV, Dh = {c['shape'][0]}, {c['shape'][2]}, "
                  f"{c['shape'][3]}, {c['shape'][4]}; causal {c['causal']}; "
                  f"{c['dtype']}{', strided' if 'layout' in c else ''}): "
                  f"max abs err {c['max_abs_err']:.3e} (tol {c['tol']})")
    # a bf16 head dim the tensor-core kernel has no form for is refused
    for dh in FLASH_REFUSED:
        q, k, v = flash_inputs((1, 64, 2, 1, dh, True, 0, 0.0, 0, 0,
                                torch.bfloat16), gen)
        try:
            fa_ops.attend(q, k, v, use_kernel=True)
            check(False, f"flash_attention took a bf16 head dim of {dh}")
        except ValueError as e:
            print(f"flash_attention, bf16 Dh={dh} refused: {e}")
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
    want = {name: expected.get(name, 0) for name in COUNTERS}
    check(counts == want, f"{what}: launches {counts}, expected {want}")


@contextlib.contextmanager
def recording_routes():
    """Every MoE layer's routing while the block runs, in call order:
    ``moe.route`` wrapped to keep (gate_idx, a mask of the routed rows
    that are all zeros: a group's padding) on the host."""
    from unittest import mock

    from repro_torch.models import moe
    route, seen = moe.route, []

    def rec(x, router, k):
        out = route(x, router, k)
        seen.append((out[2].cpu(), (x == 0).all(-1).cpu()))
        return out

    with mock.patch.object(moe, "route", rec):
        yield seen


def routing_diff(a: list, b: list, k: int, what: str) -> dict:
    """Two runs' routings: how many routed rows chose another set of
    experts, how many another top-1 expert (the one the aux loss
    counts), and how many the same experts in another order (which
    changes neither a token's output nor its capacity slots: a token takes
    each expert once, so an expert's slots follow the token order); and
    every zero (padding) row's experts, which must be 0..k-1 in both."""
    check(len(a) == len(b) and all(
        x.shape == y.shape for (x, _), (y, _) in zip(a, b)),
        f"{what}: the two runs routed other shapes")
    rows = sum(x.numel() // k for x, _ in a)
    pairs = [(x, y) for (x, _), (y, _) in zip(a, b)]
    per_call = [int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
                for x, y in pairs]
    differ = sum(per_call)
    top1 = sum(int((x[..., 0] != y[..., 0]).sum()) for x, y in pairs)
    order = sum(int((x != y).any(-1).sum()) for x, y in pairs)
    pads = sum(int(pad.sum()) for _, pad in a)
    pad_ok = all(bool((idx[pad] == torch.arange(k)).all())
                 for run in (a, b) for idx, pad in run)
    print(f"{what}: routing, {len(a)} MoE calls: {differ} of {rows} routed "
          f"rows chose another set of experts ({differ / max(rows, 1):.3e}; "
          f"the first call {per_call[0] if per_call else 0} of "
          f"{a[0][0].numel() // k if a else 0}), {top1} another top-1 "
          f"expert ({top1 / max(rows, 1):.3e}), {order} differ in experts "
          f"or their order; {pads} padding rows chose experts 0..{k - 1} "
          f"in both runs {pad_ok}")
    check(pad_ok, f"{what}: padding rows off experts 0..{k - 1}")
    return {"calls": len(a), "rows": rows, "differ": differ,
            "top1_differ": top1, "order_differ": order,
            "first_call_differ": per_call[0] if per_call else 0,
            "padding_rows": pads}


def modal_batch(cfg, batch: int, seq: int) -> dict:
    """A training batch's modality inputs on the card: Whisper's audio
    frames and Qwen2-VL's patch embeddings N(0, 1) from MODAL_SEED in the
    model dtype; Qwen2-VL's M-RoPE positions as three different streams
    (t = s, h = s // 16, w = s % 16: an image-grid layout); {} for a
    text-only decoder."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(MODAL_SEED)
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encoder_decoder:
        out["audio_embeds"] = torch.randn(
            (batch, cfg.enc_seq, cfg.d_model), generator=gen,
            device="cuda").to(dt)
    if cfg.vision_prefix:
        out["patch_embeds"] = torch.randn(
            (batch, cfg.vision_prefix, cfg.d_model), generator=gen,
            device="cuda").to(dt)
    if cfg.mrope:
        pos = torch.arange(seq, device="cuda")
        out["mrope_positions"] = torch.stack(
            [pos, pos // 16, pos % 16])[:, None].expand(3, batch, seq)
    return out


def modal_inputs(cfg, batch: int, prompt_len: int) -> dict:
    """A prefill's modality inputs for the comparisons: ``modal_batch``'s
    audio frames and patch embeddings with the stub's M-RoPE positions
    (``arange(S)`` in each stream, which the decode steps' S + i
    continue)."""
    from repro_torch.launch import serve
    kw = modal_batch(cfg, batch, prompt_len)
    if cfg.mrope:
        kw["mrope_positions"] = serve.stub_inputs(
            cfg, batch, prompt_len, "cuda")["mrope_positions"]
    return kw


def _decode_kw(model, cfg, kw: dict, batch: int, pos: int) -> dict:
    """Decode step ``pos``'s extras for a prefill run on ``kw``: M-RoPE
    positions at ``pos``, and the encoder's output of the audio."""
    from repro_torch.launch import serve
    from repro_torch.models import backbone
    enc_out = (backbone.run_encoder(model, cfg, kw["audio_embeds"])
               if "audio_embeds" in kw else None)
    return serve.decode_extras(cfg, batch, pos, "cuda", enc_out)


def phase_serve(arch: str) -> dict:
    """One main path at full width; returns its launch counts and
    steady-state times. For the MoE archs each comparison also compares
    the routing of every MoE layer. Whisper and Qwen2-VL run the
    launcher on the reference's stub inputs and every comparison on
    ``modal_inputs``."""
    from repro_torch.launch import serve
    from repro_torch.models import backbone

    main_expect, prefill_expect, step_expect = SERVE_PATHS[arch]
    argv = ["--arch", arch, *SERVE_ARGS.get(arch, ()), "--batch",
            str(BATCH), "--prompt-len", str(PROMPT), "--gen", str(GEN),
            *SAMPLE_ARGS]
    lap = laps(f"serve {arch}")
    zero_launches()
    res = serve.main(argv)
    launches = read_launches()
    lap("the launcher")
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

    kw = modal_inputs(cfg, B, S)
    with torch.inference_mode():
        step_kw = _decode_kw(res.model, cfg, kw, B, S)
        zero_launches()
        _, _, cache = backbone.prefill(res.model, cfg, res.prompts, S + GEN,
                                       **kw)
        per_prefill = read_launches()
        zero_launches()
        backbone.decode_step(res.model, cfg, res.tokens[:, :1], cache, S,
                             **step_kw)
        per_step = read_launches()
    print(f"{arch}: launches per prefill {per_prefill}, per decode step "
          f"{per_step}")
    _expect(per_prefill, prefill_expect, f"{arch} prefill")
    _expect(per_step, step_expect, f"{arch} decode step")

    routing = {}
    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    with torch.inference_mode():
        stub_logits, _, _ = backbone.prefill(
            res.model, cfg, res.prompts, S + GEN,
            **serve.stub_inputs(cfg, B, S, "cuda"))
        with recording_routes() as r_kernel:
            k_logits, _, _ = backbone.prefill(res.model, cfg, res.prompts,
                                              S + GEN, **kw)
    zero_launches()
    with torch.inference_mode(), recording_routes() as r_plain:
        plain_logits, _, _ = backbone.prefill(res.model, plain_cfg,
                                              res.prompts, S + GEN, **kw)
    _expect(read_launches(), {}, f"{arch} plain-version prefill")
    check(torch.equal(stub_logits, res.prefill_logits),
          f"{arch}: a second prefill gave other logits")
    del stub_logits
    rel = ((k_logits - plain_logits).abs().max()
           / plain_logits.abs().max()).item()
    print(f"{arch} prefill logits, kernels vs plain versions (same weights):"
          f" relative max error {rel:.3e} (bound 5e-2)")
    if cfg.n_experts:
        routing["bf16 kernels vs plain"] = routing_diff(
            r_kernel, r_plain, cfg.top_k,
            f"{arch} prefill, kernels vs plain versions")
    check(rel < 5e-2, f"{arch} prefill logits vs plain versions")
    if arch == "rwkv6-7b":
        wkv_order_witness(res.model, plain_cfg, res.prompts, plain_logits)

    lap("launches and prefills, kernels vs plain")
    with torch.inference_mode():
        profile_window(f"{arch} prefill", lambda: backbone.prefill(
            res.model, cfg, res.prompts, S + GEN, **kw))
        _, _, cache = backbone.prefill(res.model, cfg, res.prompts, S + GEN,
                                       **kw)
        tok = res.tokens[:, :1]
        steps = [_decode_kw(res.model, cfg, kw, B, S + i) for i in range(4)]
        profile_window(f"{arch} decode, 4 steps", lambda: [
            backbone.decode_step(res.model, cfg, tok, cache, S + i,
                                 **steps[i])
            for i in range(4)])
    lap("profiles")
    tokens = res.tokens.clone()
    del res, plain_logits, k_logits, cache, steps, step_kw
    _free_cuda()

    run = serve.main(argv)
    check(torch.equal(run.tokens, tokens),
          f"{arch} sampled rerun gave other tokens")
    prefill_ms, tok_s = run.prefill_s * 1e3, B * (GEN - 1) / run.decode_s
    del run
    _free_cuda()
    print(f"{arch} sampled rerun (temperature 1.0, seed 3): identical tokens")
    lap("the launcher again")

    fp32_cfg = dataclasses.replace(
        cfg, dtype="float32", n_layers=FP32_LAYERS.get(arch, cfg.n_layers))
    big, prompts = serve.build(fp32_cfg, BATCH, PROMPT, torch.device("cuda"))
    kw = modal_inputs(fp32_cfg, BATCH, PROMPT)
    with torch.inference_mode():
        with recording_routes() as r_kernel:
            k_logits, _, _ = backbone.prefill(big, fp32_cfg, prompts,
                                              S + GEN, **kw)
        with recording_routes() as r_plain:
            p_logits, _, _ = backbone.prefill(
                big, dataclasses.replace(fp32_cfg,
                                         use_pallas_attention=False),
                prompts, S + GEN, **kw)
    rel32 = ((k_logits - p_logits).abs().max()
             / p_logits.abs().max()).item()
    print(f"{arch} full width in fp32 ({fp32_cfg.n_layers} layers), kernels "
          f"vs plain versions (same weights): prefill logits relative max "
          f"error {rel32:.3e} (bound 1e-3)")
    if cfg.n_experts:
        routing["fp32 kernels vs plain"] = routing_diff(
            r_kernel, r_plain, cfg.top_k,
            f"{arch} fp32 prefill, kernels vs plain versions")
    check(rel32 < 1e-3, f"{arch} fp32 prefill logits vs plain versions")
    del big, k_logits, p_logits
    _free_cuda()
    lap("fp32 at full width")

    small_cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    small, prompts = serve.build(small_cfg, 2, 150, torch.device("cuda"))
    modal = {k: v for k, v in modal_inputs(small_cfg, 2, 150).items()
             if k != "mrope_positions"}
    with recording_routes() as r_card:
        g_logits, g_tokens, _, _ = serve.generate(small, small_cfg, prompts,
                                                  6, **modal)
    with recording_routes() as r_cpu:
        c_logits, c_tokens, _, _ = serve.generate(
            small.to("cpu"), small_cfg, prompts.cpu(), 6,
            **{k: v.cpu() for k, v in modal.items()})
    err = (g_logits.cpu() - c_logits).abs().max().item()
    same = torch.equal(g_tokens.cpu(), c_tokens)
    print(f"{arch} reduced fp32 ({small_cfg.n_layers} layers, prompt 150): "
          f"card vs CPU prefill logits max abs err {err:.3e} (tol 1e-4); "
          f"greedy tokens equal {same}")
    if cfg.n_experts:
        routing["reduced card vs CPU"] = row = routing_diff(
            r_card, r_cpu, small_cfg.top_k,
            f"{arch} reduced fp32 prefill and 5 decode steps, card vs CPU")
        check(row["order_differ"] == 0,
              f"{arch} reduced: card vs CPU routing")
    check(err < 1e-4 and same, f"{arch} reduced model: card vs CPU")
    del small
    _free_cuda()
    lap("reduced, card vs CPU")
    return {"launches": launches, "lru_scan_tma": lru_tma,
            "prefill_ms": prefill_ms, "tok_s": tok_s, "routing": routing}


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
    B, Sq, H, KV, Dh, causal, window, cap = case[:8]
    dt, Sk = case[10], key_len(case)
    q, k, v = flash_inputs(case, torch.Generator(device="cuda").manual_seed(1))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kw = dict(causal=causal, window=window, cap=cap)
    ms = cuda_ms(lambda: fa_kernel.flash_attention(q, k, v, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_ref(qt, kt, vt, **kw))
    # SDPA computes the same function only where the window masks nothing
    # and there is no soft-cap (and, causal, only at Sq == Sk: its mask
    # is aligned otherwise)
    library_ms = None
    if (not window or window >= max(Sq, Sk)) and not cap \
            and not (causal and Sq != Sk):
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)

            def lib_call():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
        except TypeError:  # torch without enable_gqa: expand kv heads first
            kx, vx = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))

            def lib_call():
                return F.scaled_dot_product_attention(qt, kx, vx,
                                                      is_causal=causal)
        library_ms = cuda_ms(lib_call)

    # the work this call's masks leave: (query, key) pairs causal (where
    # the call is) and inside the window
    qpos = torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Sk, device="cuda")[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    pairs = int(keep.sum())
    # bytes: q, k, v read and o written once
    b = bound(nbytes(q, k, v, q), 4 * B * H * pairs * Dh, dt)
    print(f"  flash_attention (B={B} H={H} KV={KV} Sq={Sq} Sk={Sk} Dh={Dh} "
          f"window={window} cap={cap} {dt} "
          f"{'causal' if causal else 'non-causal'}, model layout): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
          f"{'n/a' if library_ms is None else f'{library_ms:.4f} ms'}; "
          f"bound {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bytes']} "
          f"bytes, {b['ops']} FLOP)")
    return {"shape": [B, Sq, H, KV, Dh], "sk": Sk, "causal": causal,
            "window": window, "cap": cap, "ms": ms, "plain_ms": plain_ms,
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


def _path_launches(name: str, runs: dict, llm: dict) -> dict:
    """A kernel's launches by main path: the serving paths and the
    training paths of ``phase_llm_train`` (b) and (c)."""
    runs = dict(runs)
    for arch, row in llm["launch"].items():
        runs[f"train {arch}"] = {"launches": row["launches"]}
    for arch, fam in llm["families"].items():
        runs[f"train {arch}"] = {"launches": fam["launches"]}
    return {arch: run["launches"][name] for arch, run in runs.items()
            if run["launches"][name]}


def _entry(name: str, runs: dict, err: float, times: list,
           llm: dict) -> dict:
    """A forward kernel's row of the ``{"kernels": ...}`` line.
    ``launches`` sums the main paths' runs (``_path_launches``)."""
    by_path = _path_launches(name, runs, llm)
    first = times[0]
    extra = {}
    if name == "lru_scan":
        extra = {"launches_tma": sum(run.get("lru_scan_tma", 0)
                                     for run in runs.values())
                 + sum(fam["lru_scan_tma"]
                       for fam in llm["families"].values())}
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


def _bwd_entry(name: str, runs: dict, llm: dict) -> dict:
    """A backward kernel's row: its time at its training shape
    (``_bwd_times``: the ``Function``'s backward; for lru_scan the kernel
    alone, the ``Function``'s beside it) beside the bound, the plain
    version's backward and the library's; the largest error of phase 10
    (a); launches on the training paths."""
    fwd = name[:-len("_bwd")]
    t = llm["backward_times"][fwd]
    by_path = _path_launches(name, runs, llm)
    extra = {k: t[k] for k in ("function_ms", "plain_autograd_ms",
                               "same_traffic_ms", "binding_ms", "split_us",
                               "bound_ms_cuda_cores") if k in t}
    err = max(row["max_abs_err"] for row in llm["backward"][fwd])
    if name == "lru_scan_bwd":
        # the kernel against its own plain version (lru_scan_bwd_ref); the
        # Function's against autograd of the plain forward beside it
        extra["launches_tma"] = sum(fam["lru_scan_bwd_tma"]
                                    for fam in llm["families"].values())
        extra["function_max_abs_err"] = err
        err = max(row["bwd_max_abs_err"] for row in llm["backward"][fwd])
    if name == "wkv6_bwd":
        # the binding against its route's plain version (wkv6_bwd_plain)
        extra["function_max_abs_err"] = err
        err = max(row["bwd_max_abs_err"] for row in llm["backward"][fwd])
    return {"name": name, "route": "cuda", "source": SOURCES[name][0],
            "replaces": SOURCES[name][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **extra, "max_abs_err": err,
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            "shape": t["shape"], "other_shapes": t.get("other_shapes", [])}


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
    n = QUICKSTART_INTERVALS
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
    """A warm-up run, then TIMED_RUNS runs of ``n`` intervals, each
    applying n updates and all giving the same streams; the timed runs
    returned."""
    runs = [rt.run(n) for _ in range(1 + TIMED_RUNS)]
    check(all(int(r.state.step) == n for r in runs), f"{what}: step")
    check(all(_same_streams(runs[0], r) for r in runs[1:]),
          f"{what}: reruns differ")
    return runs[1:]


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
          f"steps/s ({TIMED_RUNS} runs after a warm-up run) "
          + ", ".join(f"{x:.1f}" for x in sps) + "; ms per interval "
          + ", ".join(f"{1e3 * r.wall_time / n:.2f}" for r in runs))
    prof = profile_window(
        f"train n_envs {SCALE['n_envs']}, {PROFILE_INTERVALS} intervals",
        lambda: rt.run(PROFILE_INTERVALS), by_stream=True)
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


FIG5_RUNS = ("hts", "sync", "stale")


def _fig5_run(name: str) -> tuple:
    """One of part fig5's runs on the card from the seed-0 params: HTS
    through ``train``, sync A2C or 16-stale async through their step
    builders. Returns (rewards (intervals, alpha, n_envs) numpy, seconds
    between synchronizes)."""
    from repro_torch import optim
    from repro_torch.core import baselines, determinism, engine
    from repro_torch.core import mesh_runtime
    from repro_torch.envs import token_env
    from repro_torch.envs.interfaces import vectorize
    from repro_torch.models import cnn_policy
    f, n = FIG5, FIG5["intervals"]
    venv = vectorize(token_env.make(vocab=f["vocab"], seed=1), f["n_envs"])
    cfg = engine.HTSConfig(alpha=f["alpha"], n_envs=f["n_envs"], seed=0,
                           entropy_coef=f["entropy_coef"])
    params = cnn_policy.init_token_policy(determinism.master_key(0),
                                          f["vocab"], hidden=f["hidden"])
    apply, opt = cnn_policy.apply_token_policy, optim.rmsprop(f["lr"],
                                                              eps=1e-5)
    acfg = baselines.AsyncConfig(**FIG5_STALE)
    run = {
        "hts": lambda: mesh_runtime.train(params, apply, venv, opt, cfg, n),
        "sync": lambda: engine.scan_intervals(
            baselines.make_sync_step(apply, venv, opt, cfg),
            baselines.sync_init_carry(params, opt, venv, cfg), n, cfg),
        "stale": lambda: engine.scan_intervals(
            baselines.make_async_step(apply, venv, opt, cfg, acfg),
            baselines.async_init_carry(params, opt, venv, cfg, acfg), n,
            cfg)}[name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, metrics = run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r = metrics["rewards"]
    check(r.shape == (n, f["alpha"], f["n_envs"]) and r.is_cuda
          and bool(torch.isfinite(r).all())
          and bool(((r >= 0) & (r <= 1)).all()),
          f"fig5 {name}: rewards {tuple(r.shape)} {r.device}")
    return r.cpu().numpy(), secs


def _fig5_worker(name: str, tmp: str) -> None:
    """``_fig5_run(name)`` in a process of its own; its result goes to
    ``tmp/<name>.pt``."""
    rewards, secs = _fig5_run(name)
    torch.save({"rewards": rewards, "seconds": secs}, f"{tmp}/{name}.pt")
    print(f"fig5 {name}: {secs:.2f} s")


def _fig5_runs(smi: str) -> dict:
    """(a) The three runs, HTS here while sync and stale async run in two
    processes of their own (the host's launches bound each run, so side
    by side they take about the time of one), and their tail rewards
    against the Fig. 5 claims (printed, not failed)."""
    import tempfile
    f, n = FIG5, FIG5["intervals"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fig5_") as tmp:
        started = _started([["-c", f"import chip_smoke as c; "
                                   f"c._fig5_worker({k!r}, {tmp!r})"]
                            for k in FIG5_RUNS[1:]])
        try:
            res = {"hts": _fig5_run("hts")}
        finally:
            _waited(started, "fig5 sync and stale async runs", "train")
        for k in FIG5_RUNS[1:]:
            got = torch.load(f"{tmp}/{k}.pt", weights_only=False)
            res[k] = got["rewards"], got["seconds"]
    wall = time.perf_counter() - t0
    rewards = {k: r for k, (r, _) in res.items()}
    secs = {k: t for k, (_, t) in res.items()}
    steps = n * f["alpha"] * f["n_envs"]
    tail = max(1, int(n * f["tail"]))
    tails = {k: float(v[-tail:].mean()) for k, v in rewards.items()}
    early = float(rewards["hts"][:5].mean())
    claims = {
        "hts learns": (tails["hts"] > early + 0.05 and tails["hts"] > 0.15,
                       f"late {tails['hts']:.4f} > early {early:.4f} + 0.05 "
                       f"and > 0.15"),
        "hts vs sync": (tails["hts"] > 0.6 * tails["sync"],
                        f"hts {tails['hts']:.4f} > 0.6 x sync "
                        f"{tails['sync']:.4f} = {0.6 * tails['sync']:.4f}"),
        "hts vs stale": (tails["hts"] >= tails["stale"] - 0.05,
                         f"hts {tails['hts']:.4f} >= stale "
                         f"{tails['stale']:.4f} - 0.05")}
    print(f"train fig5 (token env vocab {f['vocab']} x {f['n_envs']} envs, "
          f"alpha {f['alpha']}, token policy hidden {f['hidden']}, rmsprop "
          f"{f['lr']}, entropy {f['entropy_coef']}, seed 0, {n} intervals; "
          f"tail = last {tail}): tail rewards hts {tails['hts']:.4f}, sync "
          f"{tails['sync']:.4f}, stale (K {FIG5_STALE['staleness']}, "
          f"{FIG5_STALE['correction']}) {tails['stale']:.4f}; " + "; ".join(
              f"{k}: {why}: {'holds' if ok else 'does not hold'}"
              for k, (ok, why) in claims.items()))
    print(f"train fig5 times on {smi}: " + ", ".join(
        f"{k} {secs[k]:.2f} s ({steps / secs[k]:.1f} env steps/s)"
        for k in FIG5_RUNS) + f" ({steps} env steps a run, host clock "
          f"between synchronizes; sync and stale in fresh processes, "
          f"alongside hts); the three together {wall:.1f} s")
    return {"tails": tails, "early": early, "seconds": secs, "wall": wall,
            "sps": {k: steps / secs[k] for k in FIG5_RUNS},
            "claims": {k: ok for k, (ok, _) in claims.items()}}


def _fig5_unconsumed(smi: str) -> dict:
    """(b) ``train(n + 1)`` leaves its last trajectory unconsumed: its
    params are ``MeshRuntime.run(n)``'s, and a second call's, bit for
    bit."""
    from repro_torch import api
    from repro_torch.core import mesh_runtime
    n = FIG5_UNCONSUMED["intervals"]
    rt = build_session(api.load(str(QUICKSTART)), "cuda",
                       n_envs=FIG5_UNCONSUMED["n_envs"]).runtime
    out = rt.run(n)
    trained = [mesh_runtime.train(rt.params0, rt.policy_apply, rt.venv,
                                  rt.opt, rt.cfg, n + 1) for _ in range(2)]
    (a, ma), (b, mb) = trained
    vs_mesh = _params_equal(a[0].params, out.params)
    rerun = (_params_equal(a[0].params, b[0].params)
             and torch.equal(ma["rewards"], mb["rewards"])
             and torch.equal(ma["dones"], mb["dones"]))
    streams = bool((ma["rewards"][:n].cpu().numpy() == out.rewards).all())
    print(f"train fig5 (b) quickstart spec at n_envs "
          f"{FIG5_UNCONSUMED['n_envs']}, K=1: train({n + 1}) params "
          f"torch.equal to MeshRuntime.run({n}) {vs_mesh}; two train calls "
          f"equal (params, streams) {rerun}; the first {n} intervals' "
          f"rewards equal {streams}; j {int(a[4])}, updates "
          f"{int(a[0].step)}")
    check(vs_mesh, "train fig5 (b): train(n + 1) differs from run(n)")
    check(rerun, "train fig5 (b): two train calls differ")
    check(streams and int(a[4]) == n + 1 and int(a[0].step) == n,
          "train fig5 (b): streams or counts")
    return {"equals_mesh_run": vs_mesh, "rerun_equal": rerun}


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
            res = {"golden": part("train", "golden", _train_golden),
                   "quickstart": part("train", "quickstart",
                                      _train_quickstart, smi)}
    finally:
        torch.use_deterministic_algorithms(False)
    flagged = sorted({str(w.message).splitlines()[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
    print("train: ops without a deterministic implementation, used in the "
          "goldens and quickstart runs: " + ("; ".join(flagged) or "none"))
    res["scale"] = part("train", "scale", _train_scale, smi)
    res["cnn"] = part("train", "cnn", _train_cnn, smi)
    res["fig5"] = part("train", "fig5", lambda: {
        "runs": _fig5_runs(smi), "unconsumed": _fig5_unconsumed(smi)})
    launches = read_launches()
    print(f"train: launches of the port's kernels on the training path "
          f"{launches}")
    _expect(launches, {}, "training path")
    res["nondeterministic_ops"] = flagged
    print("train: " + json.dumps(res))
    return res


# --------------------------------------------------------- entry point
def _launcher(args: list, what: str, tag: str) -> str:
    """``repro_torch.launch.run.main(ARGS)`` in this process (the code a
    user's ``python -m repro_torch.launch.run ARGS`` runs, from the argv
    on, without a new process's start-up); its output printed and
    returned."""
    from repro_torch.launch import run
    t0 = time.perf_counter()
    out = "\n".join(_captured(run.main, args))
    print(f"{tag}: {what}: repro_torch.launch.run.main({args}) in this "
          f"process -> returned in {time.perf_counter() - t0:.1f}s")
    return out


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
    """(a) of phase_run and of phase_host: the launcher (with
    ``--runtime`` where the spec's is not the one asked for) stopped and
    resumed, against the ``mesh`` runtime's uninterrupted ``Session.fit``
    on the card. Both runs are the launcher's ``main`` in this process:
    the resume reads nothing but the checkpoint, and a new process would
    add only its start-up (phase_run runs the launcher as typed)."""
    from repro_torch import api
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import trainer
    quick = str(QUICKSTART.relative_to(ROOT))
    spec = api.load(str(QUICKSTART))
    pick = [] if runtime == spec.runtime.name else ["--runtime", runtime]
    tag = "run" if runtime == "mesh" else "host"     # the phase's prefix
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


def _gridmaze_cells() -> dict:
    """(c): gridmaze card vs CPU on both backends, mlp and CNNs."""
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
    return rows


def _gridmaze_scale(smi: str) -> list:
    """(d): the device backend's rate at n_envs 1024."""
    from repro_torch import api
    base = api.load(str(POOL_B))
    g = GRIDMAZE_SCALE
    rt = build_session(base, "cuda", env_backend="device", alpha=g["alpha"],
                       n_envs=g["n_envs"]).runtime
    runs = _timed_runs(rt, g["intervals"], "gridmaze scale")
    sps = [r.sps for r in runs]
    print(f"run: gridmaze scale times on {smi}: device backend, "
          f"{base.policy.name}, {base.algorithm}, K="
          f"{base.hts['staleness']}, alpha {g['alpha']} x {g['n_envs']} envs "
          f"x {g['intervals']} intervals: env steps/s ({TIMED_RUNS} runs "
          "after a warm-up run) " + ", ".join(f"{x:.1f}" for x in sps))
    return sps


def _run_football(smi: str) -> dict:
    """(e): ``python -m repro_torch.launch.run --spec
    examples/specs/football_ppo.json --intervals 4`` (``main`` in this
    process: the mini-football drill, ppo, the threaded host runtime with
    2 actors and its step-time model); then the spec's first
    FOOTBALL_INTERVALS on the card against the port's CPU: streams exact,
    params within PARAMS_TOL."""
    from repro_torch import api
    from repro_torch.launch import run
    t0 = time.perf_counter()
    lines = _captured(run.main, ["--spec", str(FOOTBALL), "--intervals",
                                 str(FOOTBALL_LAUNCH_INTERVALS)])
    wall = time.perf_counter() - t0
    spec = api.load(str(FOOTBALL))
    steps = (FOOTBALL_LAUNCH_INTERVALS * spec.hts["alpha"]
             * spec.hts["n_envs"])
    check(any(line.startswith(f"[host] {steps} steps") for line in lines),
          f"football launcher: no '[host] {steps} steps' line in {lines}")
    card, cpu = (build_session(spec, where).run(FOOTBALL_INTERVALS)
                 for where in ("cuda", "cpu"))
    same = _same_streams(card, cpu)
    diff = _params_diff(card.params, cpu.params)
    episodes = int(np.asarray(card.dones).sum())
    print(f"run: football spec on {smi}: launch.run --intervals "
          f"{FOOTBALL_LAUNCH_INTERVALS} {wall:.1f} s; "
          f"the first {FOOTBALL_INTERVALS} intervals card vs CPU: streams "
          f"equal {same} ({episodes} episode ends); params max abs diff "
          f"{diff:.3e} (tol {PARAMS_TOL})")
    check(same and episodes > 0, "football: card vs CPU streams")
    check(diff <= PARAMS_TOL, f"football: card vs CPU params {diff}")
    return {"launcher_s": wall, "streams_equal": same,
            "params_max_abs_diff": diff, "episode_ends": episodes}


def phase_run() -> dict:
    """The entry point on the card (phase 7 of the docstring). The kernel
    launch counts are zeroed before and read after the training paths:
    they launch none of the port's kernels."""
    import tempfile
    smi = nvidia_smi()
    zero_launches()
    # the launcher as typed runs in a process of its own beside the
    # checks below that time nothing; it is waited for before the timed
    # runs
    typed = _started([["-m", "repro_torch.launch.run", "--spec",
                       str(QUICKSTART.relative_to(ROOT))]])
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as d:
            tmp = Path(d)
            launcher = part("run", "launcher", _run_launcher, tmp)
            faults = part("run", "faults", _run_faults, tmp,
                          launcher.pop("straight"))
        cells = part("run", "gridmaze", _gridmaze_cells)
    finally:
        # waited for in every case: no process outlives the phase
        part("run", "the launcher as typed (its wait)", _waited, typed,
             "the quickstart spec, no other flag (beside the checks above)",
             "run")
    gridmaze = {"cells": cells,
                "scale_sps": part("run", "gridmaze scale", _gridmaze_scale,
                                  smi)}
    football = part("run", "football", _run_football, smi)
    launches = read_launches()
    print(f"run: launches of the port's kernels on the entry point's paths "
          f"{launches}")
    _expect(launches, {}, "entry point paths")
    res = {"launcher": launcher, "faults": faults, "gridmaze": gridmaze,
           "football": football}
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
        # a warm-up run, excluded from the rates
        runs = [rt.run(n) for _ in range(1 + RATE_RUNS)]
        check(all(_same_streams(runs[0], r) for r in runs[1:]),
              f"rates {name}: reruns differ")
        sps[name] = [r.sps for r in runs[1:]]
    print(f"host: rates on {smi}: quickstart spec (catch, mlp, a2c, alpha "
          f"{base.hts['alpha']} x {base.hts['n_envs']} envs) x {n} "
          f"intervals, env steps/s ({RATE_RUNS} runs after a warm-up): "
          + "; ".join(
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
        launcher = part("host", "launcher", _run_launcher, tmp, "host")
        launcher.pop("straight")
        res = {"launcher": launcher,
               "faults": part("host", "faults", _host_faults, tmp)}
    res["host_equals_mesh"] = part("host", "host_equals_mesh",
                                   _host_equals_mesh)
    res["atari_a2c"] = part("host", "atari_a2c", _atari_contenders)
    res["memory"] = part("host", "memory", _host_memory)
    res["rates"] = part("host", "rates", _host_rates, smi)
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
    checkout, as a user starts them, and waited for (``_started``,
    ``_waited``)."""
    return _waited(_started(argvs), what, tag)


def _started(argvs: list) -> tuple:
    """``python ARGV`` for each argv, all started together from the
    checkout, as a user starts them; ``_waited`` ends them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    return argvs, procs, time.perf_counter()


def _waited(started: tuple, what: str, tag: str) -> list:
    """The started processes' output, printed and returned; a non-zero
    exit or a hang past 600 s a failure. Every process is waited for (or
    killed) before this returns."""
    argvs, procs, t0 = started
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
    rank (all three processes started together), against the mesh run's
    digest; the atari_a2c CNN sharded R=2
    (two processes) against mesh, ``torch.equal``; capsules across
    replica counts; env steps/s of R=1 and R=2 beside mesh."""
    import tempfile
    from repro_torch import api
    from repro_torch.launch.distributed import params_digest
    spec = api.load(str(QUICKSTART))
    mesh = build_session(spec, "cuda").run(DISTRIBUTED_INTERVALS)
    want = params_digest(mesh.params)
    res = {"quickstart": {"mesh_sps": mesh.sps}}
    # both launches started together (three processes), each on its port
    cells = ((2, "gloo", "host"), (1, "nccl", "device"))
    ports = []
    while len(ports) < len(cells):
        port = _free_port()
        if port not in ports:
            ports.append(port)
    argvs, owner = [], []
    for (n_proc, _, _), port in zip(cells, ports):
        for i in range(n_proc):
            argvs.append(["-m", "repro_torch.launch.distributed", "--spec",
                          str(QUICKSTART), "--coordinator",
                          f"127.0.0.1:{port}", "--num-processes",
                          str(n_proc), "--process-id", str(i),
                          "--intervals", str(DISTRIBUTED_INTERVALS)])
            owner.append(n_proc)
    all_outs = _processes(argvs, "2 ranks and 1 rank, started together, on "
                          "the card", "scale")
    for n_proc, backend, route in cells:
        outs = [o for o, n in zip(all_outs, owner) if n == n_proc]
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
          f"process, the three sharing the card); atari_a2c, a rerun each: mesh {mesh_sps:.1f}, "
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
    res = {"sharded": part("scale", "sharded", _scale_sharded, smi),
           "serve": part("scale", "serve", _scale_serve, smi),
           "pool": part("scale", "pool", _scale_pool, smi)}
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


def _grad_case(name: str, call, inputs: list, label: str, gen,
               witness=None) -> dict:
    """One kernel's backward on the card: gradients of sum(out * c) (c a
    fixed N(0, 1) cotangent per output) through the kernel route under
    ``.backward()`` and under ``torch.func.grad``, against autograd of the
    plain version; each input's gradient at GRAD_TOL of its dtype; and
    ``.backward()`` again on the same inputs, ``torch.equal`` to the
    first (deterministic). ``call(*inputs, use_kernel=...)`` returns the
    output tuple. ``witness(inputs, cots)``, where given, returns fp32
    gradients of the same function: a bf16 case is also held to them
    (``_witness_check``)."""
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
    counts = read_launches()
    launched = counts[name]
    bwd = counts.get(f"{name}_bwd", 0)
    tma = mods["lru_scan"].tma_launches + mods["lru_scan"].bwd_tma_launches
    same = all(torch.equal(a, b) for a, b in zip(got, autograd(True)))
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
    err, ok = 0.0, launched > 0 and same and bwd == 1
    for g, gf, w in zip(got, got_f, want):
        for x in (g, gf):
            err = max(err, (x.float() - w.float()).abs().max().item())
            ok = ok and x.dtype == w.dtype and bool(
                torch.isfinite(x).all()) and torch.allclose(
                x.float(), w.float(), atol=tol, rtol=tol)
    route = "kernel forward and backward"
    if name == "lru_scan":
        route += f" ({tma} of {launched + bwd} launches on the TMA kernels)"
    row = {"case": label, "launches": launched, "bwd_launches": bwd,
           "route": route, "max_abs_err": err, "tol": tol,
           "deterministic": same}
    if witness is not None and bf16:
        row["witness"] = _witness_check(
            got, want, witness([inputs[i] for i in idx], cots), label)
        ok = ok and row["witness"]["ok"]
    row["ok"] = ok
    print(f"llm_train (a) {name} backward {label}: .backward() and "
          f"torch.func.grad vs autograd of the plain version max abs err "
          f"{err:.3e} (allclose at {tol}); {launched} forward and {bwd} "
          f"backward-kernel launches under .backward(); again on the same "
          f"inputs torch.equal {same}; route: {route}; ok {ok}")
    check(ok, f"{name} backward {row}")
    return row


def _witness_check(got: list, plain: list, witness: list,
                   label: str) -> dict:
    """A bf16 backward against an fp32 witness of the same function: each
    gradient no further from it than the plain bf16 version is, or
    within TRAIN_GRAD_TOL's 3e-2 of it. The plain version rounds where
    the kernel does not (its GQA dk, dv sums run in bf16), so it is no
    yardstick of precision alone."""
    tol = TRAIN_GRAD_TOL[torch.bfloat16]
    dists, ok = [], True
    for g, p, w in zip(got, plain, witness):
        g, p, w = g.float(), p.float(), w.float()
        dk, dp = ((x - w).abs().max().item() for x in (g, p))
        ok = ok and (dk <= dp or torch.allclose(g, w, atol=tol, rtol=tol))
        dists.append((dk, dp))
    print(f"llm_train (a) flash_attention backward {label}: vs the fp32 "
          "witness, kernel / plain bf16 max abs "
          + ", ".join(f"d{n} {a:.3e} / {b:.3e}" for n, (a, b)
                      in zip("qkv", dists)) + f"; ok {ok}")
    return {"kernel": [a for a, _ in dists], "plain": [b for _, b in dists],
            "ok": ok}


def _flash_witness(**kw):
    """fp32 gradients of a flash case for ``_grad_case``:
    ``ref.flash_attention_bwd_ref`` on fp32 copies of the inputs, from
    the fp32 forward's output and lse, the cotangent as the bf16 output
    passes it back."""
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_bwd_ref, flash_attention_fwd_ref)

    def witness(inputs, cots):
        xs = [x.float() for x in inputs]
        do = cots[0].to(inputs[0].dtype).float()
        o, lse = flash_attention_fwd_ref(*xs, **kw)
        return flash_attention_bwd_ref(*xs, o, lse, do, **kw)
    return witness


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
        B, S, H, KV, Dh, causal, window, cap, bq, bk, dt = case[:11]
        kw = dict(causal=causal, window=window, cap=cap, bq=bq, bk=bk)
        rows["flash_attention"].append(_grad_case(
            "flash_attention",
            lambda q, k, v, use_kernel: (fa_ops.attend(
                q, k, v, use_kernel=use_kernel, **kw),),
            flash_inputs(case, gen),
            f"(B={B} S={S} Sk={key_len(case)} H={H} KV={KV} Dh={Dh} "
            f"causal={causal} window={window} cap={cap} {dt})", gen,
            _flash_witness(causal=causal, window=window, cap=cap)))
    for case, init in TRAIN_LRU:
        a, b, h0 = lru_inputs(case, gen)
        h0 = h0 if init else None
        label = (f"(B, S, D)={case[:3]} a {case[3]}, b "
                 f"{case[4] if len(case) > 4 else case[3]}, h0 {init}")
        row = _grad_case(
            "lru_scan",
            lambda a_, b_, h_, use_kernel: lru_ops.scan(
                a_, b_, h_, use_kernel=use_kernel),
            [a, b, h0], f"{label}, cotangent on y and h_last", gen)
        row.update(_lru_bwd_plain(a, b, h0, label, gen))
        rows["lru_scan"].append(row)
    rows["flash_attention"] += [_kv_len_case(c, gen) for c in FLASH_KV_LEN]
    for case, decay in TRAIN_WKV:
        inputs = list(wkv_inputs(case, gen, decay))
        label = f"(B, T, H, N)={case[:4]} {case[4]} w {decay}"
        row = _grad_case(
            "wkv6",
            lambda *x, use_kernel: wkv_ops.mix(*x, use_kernel=use_kernel),
            inputs, label, gen)
        row.update(_wkv_bwd_plain(inputs, label, gen))
        rows["wkv6"].append(row)
    return rows


def _wkv_bwd_plain(inputs, label: str, gen) -> dict:
    """(a) for the wkv6 backward binding alone: its outputs against its
    route's plain version (``ref.wkv6_bwd_plain``: the chunked route's
    ``wkv6_chunked_bwd_ref`` or the recurrent route's
    ``wkv6_recurrent_bwd_ref``) on the same inputs, each output at
    TRAIN_GRAD_TOL of its own dtype (bf16 inputs: dr, dk, dv are rounded
    to bf16, dw, du and ds0 are fp32 and held at fp32's), with the route
    it took."""
    from repro_torch.kernels.wkv6 import kernel as wk
    from repro_torch.kernels.wkv6.ref import wkv6_bwd_plain
    r, k, v, w, u, s0 = inputs
    do = torch.randn(r.shape, generator=gen, device="cuda").to(r.dtype)
    ds_T = torch.randn(s0.shape, generator=gen, device="cuda")
    _, T, _, N = r.shape
    route = "chunked" if wk.chunked(T, N) else "recurrent"
    got = wk.wkv6_bwd(r, k, v, w, u, s0, do, ds_T)
    want = wkv6_bwd_plain(r, k, v, w, u, s0, do, ds_T)
    torch.cuda.synchronize()
    err = max((g.float() - p.float()).abs().max().item()
              for g, p in zip(got, want))
    ok = all(g.dtype == p.dtype and bool(torch.isfinite(g).all())
             and torch.allclose(g.float(), p.float(),
                                atol=TRAIN_GRAD_TOL[p.dtype],
                                rtol=TRAIN_GRAD_TOL[p.dtype])
             for g, p in zip(got, want))
    print(f"llm_train (a) wkv6 backward kernel {label}: route {route}, vs "
          f"its plain version max abs err {err:.3e} (allclose at each "
          f"output's dtype's tolerance: "
          + ", ".join(f"{n} {TRAIN_GRAD_TOL[p.dtype]}" for n, p in zip(
              ("dr", "dk", "dv", "dw", "du", "ds0"), want))
          + f"); ok {ok}")
    check(ok, f"wkv6 backward kernel vs its plain version {label}")
    return {"bwd_route": route, "bwd_max_abs_err": err, "bwd_ok": ok}


def _lru_bwd_plain(a, b, h0, label: str, gen) -> dict:
    """(a) for the lru_scan backward binding alone: its outputs
    ``torch.equal`` to its plain version ``lru_scan_bwd_ref`` on the same
    inputs (y from the forward kernel), with the route it took; where
    that is the TMA kernel, the per-thread one (forced) as well."""
    from repro_torch.kernels.lru_scan import kernel as lk
    from repro_torch.kernels.lru_scan.ref import lru_scan_bwd_ref
    y, _ = lk.lru_scan(a, b, h0)
    gy = torch.randn(y.shape, generator=gen, device="cuda").to(y.dtype)
    ghl = torch.randn(y[:, 0].shape, generator=gen, device="cuda")
    before = lk.bwd_tma_launches
    outs = [lk.lru_scan_bwd(a, h0, y, gy, ghl, b.dtype)]
    route = "tma" if lk.bwd_tma_launches > before else "per-thread"
    if route == "tma":
        outs.append(lk.lru_scan_bwd(a, h0, y, gy, ghl, b.dtype, tma=False))
    want = lru_scan_bwd_ref(a, h0, y, gy, ghl, b.dtype)
    torch.cuda.synchronize()
    pairs = [(g, w) for got in outs for g, w in zip(got, want)
             if w is not None]
    equal = all(torch.equal(g, w) for g, w in pairs)
    err = max((g.float() - w.float()).abs().max().item() for g, w in pairs)
    print(f"llm_train (a) lru_scan backward kernel {label}: route {route}"
          + (" (and the per-thread kernel, forced)" if len(outs) > 1 else "")
          + f", torch.equal to lru_scan_bwd_ref {equal} (max abs err "
          f"{err:.3e})")
    check(equal, f"lru_scan backward kernel vs its plain version {label}")
    return {"bwd_route": route, "bwd_equal_plain": equal,
            "bwd_max_abs_err": err}


def _kv_len_case(case, gen) -> dict:
    """(a) with a ``kv_len`` mask, through the bindings (the model passes
    none): the forward with its lse and the backward kernel against
    autograd of the plain forward (``flash_attention_fwd_ref``), twice
    for equal gradients."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import \
        flash_attention_fwd_ref
    B, Sq, Sk, H, KV, Dh, causal, dt, kv_len = case
    q = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, Sk, KV, Dh), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    do = torch.randn((B, Sq, H, Dh), generator=gen, device="cuda").to(dt)
    kw = dict(causal=causal, kv_len=kv_len)
    zero_launches()
    o, lse = fk.flash_attention(q, k, v, lse=True, **kw)
    got = fk.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fk.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    counts = read_launches()
    xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        flash_attention_fwd_ref(*xs, **kw)[0], xs, do)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    tol = TRAIN_GRAD_TOL[dt]
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    ok = same and all(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
                      for a, b in zip(got, want))
    label = (f"(B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} Dh={Dh} causal={causal}"
             f" kv_len={kv_len} {dt})")
    print(f"llm_train (a) flash_attention backward {label} through the "
          f"bindings: vs autograd of the plain forward max abs err "
          f"{err:.3e} (allclose at {tol}); again torch.equal {same}; ok "
          f"{ok}")
    row = {"case": label, "launches": counts["flash_attention"],
           "bwd_launches": counts["flash_attention_bwd"],
           "route": "the bindings", "max_abs_err": err, "tol": tol,
           "deterministic": same}
    if dt == torch.bfloat16:
        row["witness"] = _witness_check(
            got, want, _flash_witness(**kw)([q, k, v], [do]), label)
        ok = ok and row["witness"]["ok"]
    row["ok"] = ok
    check(ok, f"flash_attention backward with kv_len {label}")
    return row


def _flash_fwd_lse_ms(q, k, v) -> dict:
    """The forward binding with and without the lse it writes for the
    backward (serving asks for none), at one shape."""
    from repro_torch.kernels.flash_attention import kernel as fk
    row = {"fwd_ms": cuda_ms(lambda: fk.flash_attention(q, k, v)),
           "fwd_lse_ms": cuda_ms(lambda: fk.flash_attention(q, k, v,
                                                            lse=True))}
    print(f"  flash_attention forward {list(q.shape)}: {row['fwd_ms']:.4f} "
          f"ms, with the lse {row['fwd_lse_ms']:.4f} ms (0.0390 ms before "
          "the forward could write one; PERF.md)")
    return row


def _visible_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs a mask lets through, the work the bounds count."""
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    ok = np.ones((Sq, Sk), bool)
    if causal:
        ok &= k <= q
    if window:
        ok &= k > q - window
    return int(ok.sum())


# autograd.grad costs the host far more than a launch: a ~50 ms spin keeps
# the timed backwards queued behind it (device time)
GRAD_SPIN = 100_000_000


def _sdpa_differs(S: int, Sk: int, causal: bool, window: int,
                  cap: float) -> str | None:
    """Why SDPA does not compute the kernel's function at a shape, or None
    where it does: no soft-cap, a window that masks nothing, causal only
    at Sq == Sk (SDPA's causal mask is not the kernel's there)."""
    if cap:
        return "soft-cap"
    if window and window < max(S, Sk):
        return f"window {window}"
    if causal and S != Sk:
        return "causal at Sq != Sk"
    return None


def _sdpa_bwd_ms(q, k, v, causal: bool, gen) -> float:
    """SDPA's backward (autograd.grad, the library's own kernels) on the
    kernel's inputs laid out as SDPA takes them, (B, H, S, Dh)."""
    H, KV = q.shape[2], k.shape[2]
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    try:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
    except TypeError:   # torch without enable_gqa
        o = F.scaled_dot_product_attention(
            qt, kt.repeat_interleave(H // KV, 1),
            vt.repeat_interleave(H // KV, 1), is_causal=causal)
    g = torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype)
    return cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), g,
                                               retain_graph=True),
                   10, 2, GRAD_SPIN)


# the flash backward binding's ms at the training shapes (TRAIN_FLASH's
# last 11, in PREFILL_ATTN's order) before the fused kernel, on an NVIDIA
# H100 80GB HBM3 at 700.00 W (PERF.md): the first hand-written kernel
# (FA2's split) and the parent tree of the fused kernel (the mean of two
# runs beside it in one call, scripts/flash_bwd_compare.py)
FLASH_BWD_FIRST_MS = (0.1949, 0.3677, 0.2655, 0.4316, 0.3377, 0.1094, 0.3114,
                      0.6992, 0.2697, 0.0943, 0.4314)
FLASH_BWD_PARENT_MS = (0.1962, 0.3644, 0.2635, 0.4279, 0.3345, 0.1091,
                       0.3099, 0.6904, 0.2682, 0.0944, 0.4295)


def _flash_bwd_shapes(gen) -> list:
    """The backward kernel alone (the bindings, inputs from the forward
    with its lse) at every arch's training shape, beside its bound, SDPA's
    backward wherever SDPA computes the same function. The two earlier
    kernels' times are constants from PERF.md: printed beside each shape,
    and kept out of the rows, which go into the kernels line."""
    from repro_torch.kernels.flash_attention import kernel as fk
    rows = []
    for i, case in enumerate(TRAIN_FLASH[-len(PREFILL_ATTN):]):
        B, S, H, KV, Dh, causal, window, cap, *_, dt = case[:11]
        q, k, v = flash_inputs(case, gen)
        kw = dict(causal=causal, window=window, cap=cap)
        o, lse = fk.flash_attention(q, k, v, lse=True, **kw)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
        ms = cuda_ms(lambda: fk.flash_attention_bwd(q, k, v, o, lse, do,
                                                    **kw), 10, 2)
        Sk = k.shape[1]
        pairs = _visible_pairs(S, Sk, causal, window)
        differs = _sdpa_differs(S, Sk, causal, window, cap)
        lib_ms = None if differs else _sdpa_bwd_ms(q, k, v, causal, gen)
        row = {"shape": [B, S, Sk, H, KV, Dh, causal, window, cap], "ms": ms,
               "library_ms": lib_ms, "library_none": differs,
               **bound(nbytes(q, k, v, o, do, q, k, v, lse, lse),
                       10 * B * H * pairs * Dh, dt)}
        lib = (f"none ({differs})" if differs else f"{lib_ms:.4f} ms")
        print(f"  flash_attention backward kernel {row['shape']}: {ms:.4f} "
              f"ms; SDPA's backward {lib}; bound {row['bound_ms']:.4f} ms "
              f"by {row['bound_by']}; the first kernel "
              f"{FLASH_BWD_FIRST_MS[i]:.4f} ms, "
              f"the parent tree {FLASH_BWD_PARENT_MS[i]:.4f} ms (PERF.md)")
        rows.append(row)
    return rows


def _bwd_times() -> dict:
    """Each backward at its training shape: the kernel route's backward
    (autograd.grad through the ``Function``), the plain version's
    backward (autograd of its graph) and, for flash attention, SDPA's
    backward, with a bound for the backward's work."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lru_scan import kernel as lru_kernel
    from repro_torch.kernels.lru_scan import ops as lru_ops
    from repro_torch.kernels.lru_scan.ref import (lru_scan_bwd_ref,
                                                  lru_scan_ref)
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    spin = GRAD_SPIN

    def timed(fn_kernel, fn_plain, inputs, iters=10, warmup=2):
        xs = [x.detach().clone().requires_grad_() for x in inputs]
        o_k = fn_kernel(*xs)
        o_p = fn_plain(*xs)
        cots = [torch.randn(o.shape, generator=gen, device="cuda").to(
            o.dtype) for o in o_k]
        k_ms = cuda_ms(lambda: torch.autograd.grad(
            o_k, xs, cots, retain_graph=True), iters, warmup, spin)
        p_ms = cuda_ms(lambda: torch.autograd.grad(
            o_p, xs, cots, retain_graph=True), iters, warmup, spin)
        return k_ms, p_ms, xs, cots

    # flash attention at StarCoder2's shape
    B, S, H, KV, Dh, causal, window, *_, dt = MAIN_TRAIN
    q, k, v = flash_inputs(MAIN_TRAIN, gen)
    k_ms, p_ms, _, _ = timed(
        lambda *x: (fa_ops.attend(*x, causal=True),),
        lambda *x: (fa_ops.attend(*x, causal=True, use_kernel=False),),
        [q, k, v])
    lib_ms = _sdpa_bwd_ms(q, k, v, True, gen)
    pairs = S * (S + 1) // 2
    # q, k, v, o and do read, dq, dk, dv written; 5 products of the
    # (query, key) pairs: S = q k^T again, dV, dP, dQ, dK
    bd = bound(nbytes(q, k, v, q, q, q, k, v), 10 * B * H * pairs * Dh, dt)
    out["flash_attention"] = {"shape": [B, S, H, KV, Dh], "ms": k_ms,
                              "plain_ms": p_ms, "library_ms": lib_ms, **bd,
                              **_flash_fwd_lse_ms(q, k, v),
                              "other_shapes": _flash_bwd_shapes(gen)}
    # lru_scan at RecurrentGemma's shape: the backward kernel alone and
    # through the Function (autograd.grad of the kernel route), its plain
    # version and autograd of the plain forward
    a, b, h0 = lru_inputs(LRU_TRAIN, gen)
    f_ms, pa_ms, _, _ = timed(lambda *x: lru_ops.scan(*x),
                              lambda *x: lru_scan_ref(*x), [a, b, h0],
                              iters=5, warmup=1)
    y, _ = lru_kernel.lru_scan(a, b, h0)
    gy, ghl = (torch.randn(t.shape, generator=gen, device="cuda")
               for t in (y, h0))
    k_ms = cuda_ms(lambda: lru_kernel.lru_scan_bwd(a, h0, y, gy, ghl,
                                                   b.dtype))
    p_ms = cuda_ms(lambda: lru_scan_bwd_ref(a, h0, y, gy, ghl, b.dtype),
                   iters=3, warmup=1)
    # a yardstick of the rate this traffic gets, not the same function: one
    # elementwise PyTorch op that reads three tensors of this size and
    # writes two (SGD with momentum: param, grad, buffer in; param, buffer
    # out)
    par, grad, buf = (torch.randn(a.shape, generator=gen, device="cuda")
                      for _ in range(3))
    sgd_ms = cuda_ms(lambda: torch._fused_sgd_(
        [par], [grad], [buf], weight_decay=0.0, momentum=0.9, lr=1e-6,
        dampening=0.0, nesterov=False, maximize=False, is_first_step=False))
    # a, y, gy, h0, gh_last read; da, db, dh0 written; per element the
    # multiply-add and the da product
    bd = bound(nbytes(a, y, gy, h0, ghl, a, a, h0), 3 * a.numel(),
               torch.float32)
    print(f"  lru_scan backward kernel {list(a.shape)}: {k_ms:.4f} ms, "
          f"{bd['bytes'] / (k_ms * 1e-3) / 1e9:.1f} GB/s; through the "
          f"Function {f_ms:.4f} ms; lru_scan_bwd_ref {p_ms:.4f} ms; "
          f"torch._fused_sgd_ (the same traffic, 3 tensors in, 2 out) "
          f"{sgd_ms:.4f} ms")
    out["lru_scan"] = {"shape": list(a.shape), "ms": k_ms, "function_ms": f_ms,
                       "plain_ms": p_ms, "plain_autograd_ms": pa_ms,
                       "same_traffic_ms": sgd_ms, "library_ms": None, **bd}
    # wkv6 at RWKV-6's shape
    r, kk, vv, w, u, s0 = wkv_inputs(WKV_TRAIN, gen)
    k_ms, p_ms, _, _ = timed(lambda *x: wkv_ops.mix(*x),
                             lambda *x: wkv6_ref(*x), [r, kk, vv, w, u, s0],
                             iters=2, warmup=1)
    Bw, T, Hw, N, _ = WKV_TRAIN
    # inputs and both cotangents read, every input's gradient written;
    # the least FLOP counted as twice the forward's (each forward product
    # has two gradient products), at the rate of the units that do them as
    # in wkv_times: TF32 tensor cores for the chunked route, the CUDA cores
    # for the recurrent one; the CUDA-core reading is kept beside it (the
    # bound earlier slices reported)
    n_bytes, n_ops = (2 * nbytes(r, kk, vv, w, u, s0) + nbytes(r, s0),
                      2 * Bw * Hw * T * (5 * N * N + 5 * N))
    bd = bound(n_bytes, n_ops,
               "tf32" if wkv_kernel.chunked(T, N) else torch.float32)
    cuda_cores = bound(n_bytes, n_ops, torch.float32)["bound_ms"]
    # the binding alone, and its time by kernel
    do = torch.randn(r.shape, generator=gen, device="cuda").to(r.dtype)
    ds_T = torch.randn(s0.shape, generator=gen, device="cuda")

    def binding():
        return wkv_kernel.wkv6_bwd(r, kk, vv, w, u, s0, do, ds_T)
    b_ms = cuda_ms(binding, 10, 2)
    split = kernel_split(binding)
    print(f"  wkv6 backward binding {[Bw, T, Hw, N]}: {b_ms:.4f} ms; by "
          "kernel (us a launch, torch.profiler): "
          + (", ".join(f"{n} {us:.1f}" for n, us in sorted(
              split.items(), key=lambda kv: -kv[1])) or "not measured"))
    out["wkv6"] = {"shape": [Bw, T, Hw, N], "ms": k_ms, "plain_ms": p_ms,
                   "library_ms": None, "binding_ms": b_ms,
                   "split_us": split, "bound_ms_cuda_cores": cuda_cores,
                   **bd}
    for name, row in out.items():
        lib = ("n/a" if row["library_ms"] is None
               else f"{row['library_ms']:.4f} ms")
        print(f"  {name} backward {row['shape']}: kernel route "
              f"{row['ms']:.4f} ms, plain version's backward "
              f"{row['plain_ms']:.4f} ms, library {lib}; bound "
              f"{row['bound_ms']:.4f} ms by {row['bound_by']} "
              f"({row['bytes']} bytes, {row['ops']} FLOP"
              + (f"; {row['bound_ms_cuda_cores']:.4f} ms at the CUDA cores' "
                 "67 TFLOP/s fp32" if "bound_ms_cuda_cores" in row else "")
              + ")")
    return out


def _memory_reckoning(cfg) -> dict:
    """The training state's bytes: params, params_prev and the gradients
    in each leaf's dtype, Adam's m and v in fp32."""
    from repro_torch.models import backbone
    leaves = list(backbone.Backbone(cfg, device="meta").parameters())
    n = sum(p.numel() for p in leaves)
    state = sum(p.numel() * (3 * p.element_size() + 8) for p in leaves)
    return {"params": n, "state_bytes": state}


def _llm_launch(arch: str, smi: str, flash: int | None = None) -> dict:
    """(b): ``python -m repro_torch.launch.train --arch <arch> --steps 3
    --batch 4 --seq 512`` as typed (``main`` in this process, so the
    launch counts and the peak memory can be read), with ``flash``
    (LLM_TRAIN's by default) flash launches a step. The MoE arch's
    load-balance loss (the step's ``aux``) must be nonzero."""
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
            stamps.append((time.perf_counter(), float(out[1]["loss"]),
                           float(out[1]["aux"])))
            return out
        return timed

    argv = ["--arch", arch, "--steps", str(LLM_STEPS), "--batch",
            str(LLM_BATCH), "--seq", str(LLM_SEQ)]
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with mock.patch.object(stream_runtime.learner, "make_train_step",
                           timed_steps):
        train.main(argv)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    check(len(stamps) == LLM_STEPS, f"{arch} ran {len(stamps)} steps")
    losses = [x for _, x, _ in stamps]
    aux = [a for _, _, a in stamps]
    cfg = get_config(arch)
    check(all(np.isfinite(losses + aux))
          and (not cfg.n_experts or all(a > 0 for a in aux)),
          f"{arch} losses {losses}, aux {aux}")
    times = [t for t, _, _ in stamps]
    step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
    tok_s = LLM_BATCH * LLM_SEQ * len(step_ms) / (times[-1] - times[0])
    reck = _memory_reckoning(cfg)
    per_step = {k: v / LLM_STEPS for k, v in launches.items()}
    print(f"llm_train (b) launch.train {' '.join(argv)} on {smi}: losses "
          f"{losses} (the RL loss; the load-balance aux {aux}); ms per step "
          f"after the first {step_ms}; {tok_s:.1f} tokens/s; peak memory "
          f"{peak / 1e9:.2f} GB (max_memory_allocated) against the "
          f"training state's {reck['state_bytes'] / 1e9:.2f} GB "
          f"({reck['params']:,} params: params, params_prev, grads in bf16,"
          f" Adam m and v fp32); launches {launches}, per step {per_step}; "
          f"{wall:.1f} s in all")
    flash = LLM_TRAIN[arch] if flash is None else flash
    # the backward kernel once a layer: half the forward's (forward and
    # the checkpointed layer's recompute)
    _expect(launches, {"flash_attention": flash * LLM_STEPS,
                       "flash_attention_bwd": flash // 2 * LLM_STEPS},
            f"{arch} training")
    _free_cuda()
    return {"losses": losses, "aux": aux, "step_ms": step_ms,
            "tokens_s": tok_s, "peak_bytes": peak, **reck,
            "launches": launches, "launches_per_step": per_step,
            "wall_s": wall}


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
    mods = kernel_modules()
    lru_tma = mods["lru_scan"].tma_launches
    lru_bwd_tma = mods["lru_scan"].bwd_tma_launches
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
          f"lru_scan and its backward on the TMA kernels {lru_tma} and "
          f"{lru_bwd_tma}); peak memory {peak / 1e9:.2f} GB; {wall:.1f} s")
    _expect(launches, {k: v * LLM_SPEC_STEPS for k, v in per_step.items()},
            f"{arch} training")
    check(lru_tma == launches["lru_scan"]
          and lru_bwd_tma == launches["lru_scan_bwd"],
          f"{arch}: lru_scan launches off the TMA kernels")
    _free_cuda()
    first = {dtype: _first_step(arch, n_layers, dtype, tol)
             for dtype, tol in (("bfloat16", LLM_LOSS_TOL),
                                ("float32", CARD_CPU_LOSS_TOL))}
    return {"n_layers": n_layers, "losses": losses, "launches": launches,
            "lru_scan_tma": lru_tma, "lru_scan_bwd_tma": lru_bwd_tma,
            "peak_bytes": peak,
            "first_step": first, "wall_s": wall}


def _first_step(arch: str, n_layers: int, dtype: str,
                loss_tol: float) -> dict:
    """(c): the first step's loss and every gradient leaf on the card,
    kernels against plain versions, on the weights of seed 0 in
    ``dtype``. For RWKV-6 each leaf's distance is printed beside that of
    a witness with the kernel's own rounding: the kernel's ``Function``
    with its binding replaced by ``wkv6_chunked_ref``. For an MoE arch
    the two runs' routing is compared (forward and the checkpointed
    recompute), and in fp32 every row must choose the same experts and
    the same top-1 (a swap of two near-equal gates only reorders a row:
    PERF.md §6). The loss is held at ``loss_tol``; the leaves at
    LLM_GRAD_REL_L2[dtype][arch] where that is set."""
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
    batch.update(modal_batch(cfg, LLM_BATCH, LLM_SEQ))
    with recording_routes() as r_kernel:
        loss_k, grads_k = _train_grads(cfg, params, batch, True)
    with recording_routes() as r_plain:
        loss_p, grads_p = _train_grads(cfg, params, batch, False)
    routing = None
    if cfg.n_experts:
        routing = routing_diff(
            r_kernel, r_plain, cfg.top_k,
            f"llm_train (c) {arch} {dtype} first step, kernels vs plain "
            "versions")
    del r_kernel, r_plain
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
          and (bound is None or rel[worst] <= bound)
          and (routing is None or dtype != "float32"
               or routing["differ"] == routing["top1_differ"] == 0),
          f"{arch} {dtype}: first step kernels vs plain versions")
    return {"loss_kernel": loss_k, "loss_plain": loss_p,
            "grad_rel_l2_max": [worst, rel[worst]], "bound": bound,
            "witness_rel_l2_max": max(witness.values(), default=None),
            "routing": routing}


def _llm_resume(tmp: Path) -> dict:
    """(d): StarCoder2-3B at full width with 1 layer through the
    launcher: stopped at 2 and resumed to 4 equals an uninterrupted 4
    steps, every checkpoint leaf (each run's final state as its
    checkpoint stores it, read from its ``Session``)."""
    from repro_torch import bridge
    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import train
    base = ["--arch", "starcoder2-3b", "--n-layers", str(LLM_RESUME_LAYERS),
            "--batch", str(LLM_BATCH), "--seq", str(LLM_SEQ)]
    a = tmp / "resume_a"

    def stored(session) -> list:
        return [ckpt_io._stored(leaf) for leaf in tree_leaves(
            bridge.backbone_state_to_reference(session.state().algo,
                                               session.policy.config))]

    t0 = time.perf_counter()
    _free_cuda()
    train.main(base + ["--ckpt-dir", str(a), "--ckpt-every", "2",
                       "--steps", "2"])
    _free_cuda()
    got = stored(train.main(base + ["--ckpt-dir", str(a), "--resume",
                                    "--steps", "4"]))
    _free_cuda()
    want = stored(train.main(base + ["--steps", "4"]))
    _free_cuda()
    same = len(got) == len(want) and all(
        x.dtype == y.dtype and np.array_equal(x, y) for x, y in zip(got, want))
    n_bytes = sum(y.nbytes for y in want)
    print(f"llm_train (d) starcoder2-3b, {LLM_RESUME_LAYERS} layers at full "
          f"width: --ckpt-every 2 --steps 2, then --resume --steps 4, "
          f"against --steps 4: {len(want)} checkpoint leaves "
          f"({n_bytes / 1e9:.2f} GB) equal {same}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(same, "starcoder2-3b resumed run differs from the straight run")
    return {"leaves": len(want), "bytes": n_bytes, "equal": same}


def _llm_card_vs_cpu() -> dict:
    """(e): each family's reduced config in fp32, 3 steps of the stream
    runtime on the card (kernels) and on the CPU (plain versions) from
    the same weights: SGD's losses and params, Adam's losses; and a
    rerun on the card, bit for bit. The MoE configs (Granite with the
    capacity and the dropless dispatch; Llama-4 with its shared expert
    and NoPE global layer) also route every row alike on both."""
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import HTSConfig
    from repro_torch.core.stream_runtime import StreamRuntime
    from repro_torch.core.tree import tree_leaves
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import backbone
    rows = {}
    for label, (arch, overrides, kernels) in LLM_CARD_CPU.items():
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32", use_pallas_attention=True,
                                  **overrides)
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
                with recording_routes() as routes:
                    out = rt.run(3)
                runs.setdefault(dev, []).append(
                    (out.metrics["loss"], rt.state().algo, read_launches(),
                     routes))
            (l_gpu, s_gpu, n_gpu, r_gpu), (_, s_again, _, _) = runs["cuda"]
            l_cpu, s_cpu, n_cpu, r_cpu = runs["cpu"][0]
            route_row = None
            if cfg.n_experts:
                route_row = routing_diff(
                    r_gpu, r_cpu, cfg.top_k,
                    f"llm_train (e) {label} reduced fp32, {opt_name}, card "
                    "vs CPU")
            rerun = all(torch.equal(x, y) for x, y in zip(
                tree_leaves(s_gpu), tree_leaves(s_again)))
            loss_err = float(np.abs(l_gpu - l_cpu).max())
            par = max(((s_gpu.params[n] - s_cpu.params[n]).abs().max()
                       / s_cpu.params[n].abs().max().clamp_min(1e-30)).item()
                      for n in s_cpu.params)
            ok = (rerun and loss_err <= CARD_CPU_LOSS_TOL
                  and all(n_gpu[k] > 0 for k in kernels)
                  and (route_row is None or route_row["order_differ"] == 0)
                  and (opt_name != "sgd" or par <= CARD_CPU_PARAMS_TOL))
            print(f"llm_train (e) {label} reduced fp32, {opt_name}, 3 steps: "
                  f"card vs CPU losses max abs err {loss_err:.3e} (tol "
                  f"{CARD_CPU_LOSS_TOL}); params max err relative to each "
                  f"leaf's largest {par:.3e} ("
                  + (f"tol {CARD_CPU_PARAMS_TOL}" if opt_name == "sgd" else
                     "printed: Adam's first steps divide near-zero gradient "
                     "entries by their own size")
                  + f"); card rerun bit for bit {rerun}; card launches "
                  f"{n_gpu}")
            check(ok, f"{label} {opt_name}: card vs CPU")
            row[opt_name] = {"loss_err": loss_err, "params_rel_err": par,
                             "rerun_equal": rerun, "launches": n_gpu,
                             "routing": route_row}
        rows[label] = row
    _free_cuda()
    return rows


def _modal_train(arch: str, n_layers: int, smi: str, per_step: int,
                 bwd_per_step: int) -> dict:
    """(f): LLM_STEPS steps of ``learner.make_train_step`` (Adam, bf16,
    the kernels on) at full width with ``n_layers`` layers, on token
    batches of the stream with ``modal_batch``'s inputs: losses finite,
    ms per step and tokens/s after the first, the peak memory beside the
    state's reckoning, ``per_step`` flash forward and ``bwd_per_step``
    backward launches a step."""
    from repro_torch import models, optim
    from repro_torch.core import delayed_grad, determinism, learner
    from repro_torch.data.pipeline import TokenStream
    policy = models.get_policy("backbone", None, arch=arch,
                               n_layers=n_layers, use_pallas_attention=True)
    cfg = policy.config
    _free_cuda()
    torch.cuda.reset_peak_memory_stats()
    opt = optim.get_optimizer("adam", lr=1e-4)
    dg = delayed_grad.init(policy.init(determinism.master_key(
        0, device="cuda")), opt)
    step = learner.make_train_step(cfg, opt, "a2c")
    stream = TokenStream(cfg.vocab_size, LLM_BATCH, LLM_SEQ, 0,
                         device="cuda")
    extra = modal_batch(cfg, LLM_BATCH, LLM_SEQ)
    zero_launches()
    stamps, losses = [time.perf_counter()], []
    for _ in range(LLM_STEPS):
        dg, stats = step(dg, {**stream.next_batch(), **extra})
        losses.append(float(stats["loss"]))       # synchronizes
        stamps.append(time.perf_counter())
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    del dg, step, extra
    _free_cuda()
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    tok_s = LLM_BATCH * LLM_SEQ * len(step_ms) / (stamps[-1] - stamps[1])
    reck = _memory_reckoning(cfg)
    print(f"llm_train (f) {arch} n_layers={n_layers} d_model={cfg.d_model} "
          f"bf16, make_train_step with Adam, {LLM_STEPS} steps of "
          f"{LLM_BATCH}x{LLM_SEQ} tokens" + (
              f" and {LLM_BATCH}x{cfg.enc_seq} audio frames"
              if cfg.is_encoder_decoder else "") + (
              f" with {cfg.vision_prefix} patch positions and 3 M-RoPE "
              "streams" if cfg.mrope else "") + f" on {smi}: losses "
          f"{losses}; ms per step after the first {step_ms}; {tok_s:.1f} "
          f"tokens/s; peak memory {peak / 1e9:.2f} GB against the training "
          f"state's {reck['state_bytes'] / 1e9:.2f} GB ({reck['params']:,} "
          f"params); launches {launches}")
    check(all(np.isfinite(losses)), f"{arch} losses {losses}")
    _expect(launches, {"flash_attention": per_step * LLM_STEPS,
                       "flash_attention_bwd": bwd_per_step * LLM_STEPS},
            f"{arch} training")
    return {"n_layers": n_layers, "losses": losses, "step_ms": step_ms,
            "tokens_s": tok_s, "peak_bytes": peak, **reck,
            "launches": launches}


def _qwen_train(smi: str) -> dict:
    """(f): Qwen2-VL-72B with Adam at QWEN_TRAIN_LAYERS layers; on an
    out-of-memory, recorded, at one layer."""
    arch = "qwen2-vl-72b"
    for n in (QWEN_TRAIN_LAYERS, 1):
        try:
            row = _modal_train(arch, n, smi, 2 * n, n)
            if n != QWEN_TRAIN_LAYERS:
                row["oom_at"] = QWEN_TRAIN_LAYERS
            return row
        except torch.cuda.OutOfMemoryError as e:
            print(f"llm_train (f) {arch} n_layers={n} with Adam: out of "
                  f"memory ({str(e).splitlines()[0]})")
            _free_cuda()
            check(n != 1, f"{arch}: one layer with Adam ran out of memory")


def _blocked_on_card(smi: str) -> dict:
    """(g): ``blocked_attention`` against ``attend_plain`` on the card,
    forward and q, k, v gradients of sum(out * c) at TRAIN_GRAD_TOL, with
    each one's forward-and-backward time and peak memory; then one
    StarCoder2-3B first step at full width and depth through the kernel
    route (``use_pallas_attention``: the kernel's forward and its
    backward kernel) and through the blocked route, with each one's peak
    memory and time; their losses within LLM_LOSS_TOL."""
    from repro_torch import models
    from repro_torch.core import determinism
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models.attention import blocked_attention
    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for case in BLOCKED_CASES:
        B, S, H, KV, Dh, causal, window, cap = case[:8]
        dt = case[10]
        q, k, v = flash_inputs(case, gen)
        cot = torch.randn(q.shape, generator=gen, device="cuda")
        kw = dict(causal=causal, window=window, cap=cap)
        runs = {}
        for name, fn in (("blocked", lambda *x: blocked_attention(*x, **kw)),
                         ("plain", lambda *x: fa_ops.attend(
                             *x, use_kernel=False, **kw))):
            xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
            _free_cuda()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            out = fn(*xs)
            grads = torch.autograd.grad((out.float() * cot).sum(), xs)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base

            def fwd_bwd(fn=fn):
                ys = [x.detach().requires_grad_() for x in (q, k, v)]
                torch.autograd.grad((fn(*ys).float() * cot).sum(), ys)
            runs[name] = (out, grads, peak, cuda_ms(fwd_bwd, 3, 1))
        (o_b, g_b, peak_b, ms_b), (o_p, g_p, peak_p, ms_p) = (
            runs["blocked"], runs["plain"])
        tol = TRAIN_GRAD_TOL[dt]
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip((o_b, *g_b), (o_p, *g_p))]
        ok = all(torch.allclose(a.float(), b.float(), atol=tol, rtol=tol)
                 and a.dtype == b.dtype and bool(torch.isfinite(a).all())
                 for a, b in zip((o_b, *g_b), (o_p, *g_p)))
        label = (f"(B={B} Sq={S} Sk={key_len(case)} H={H} KV={KV} Dh={Dh} "
                 f"causal={causal} window={window} cap={cap} {dt})")
        print(f"llm_train (g) blocked_attention vs attend_plain {label} on "
              f"the card: out, dq, dk, dv max abs err "
              + ", ".join(f"{e:.3e}" for e in errs) + f" (allclose at {tol});"
              f" forward and backward {ms_b:.3f} ms vs {ms_p:.3f} ms; peak "
              f"above the inputs {peak_b / 1e6:.1f} MB vs "
              f"{peak_p / 1e6:.1f} MB; ok {ok}")
        check(ok, f"blocked_attention vs attend_plain {label}")
        rows.append({"case": label, "max_abs_err": max(errs), "tol": tol,
                     "ms": ms_b, "plain_ms": ms_p, "peak_bytes": peak_b,
                     "plain_peak_bytes": peak_p})
        del runs, o_b, g_b, o_p, g_p
    _free_cuda()
    policy = models.get_policy("backbone", None, arch="starcoder2-3b",
                               use_pallas_attention=True)
    cfg = policy.config
    params = policy.init(determinism.master_key(0, device="cuda"))
    batch = {k: v.cuda() for k, v in TokenStream(
        cfg.vocab_size, LLM_BATCH, LLM_SEQ, 0).skip(1).next_batch().items()}
    route = {}
    for use_kernel in (True, False):
        _free_cuda()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = _train_grads(cfg, params, batch, use_kernel)
        torch.cuda.synchronize()
        route["kernel" if use_kernel else "blocked"] = {
            "loss": loss, "peak_bytes": torch.cuda.max_memory_allocated(),
            "s": time.perf_counter() - t0}
        del grads
    del params
    _free_cuda()
    kr, br = route["kernel"], route["blocked"]
    print(f"llm_train (g) starcoder2-3b (30 layers, full width, bf16) first "
          f"step on {smi}: the kernel route loss {kr['loss']:.6f}, peak "
          f"{kr['peak_bytes'] / 1e9:.2f} GB, {kr['s']:.3f} s; the blocked "
          f"route loss {br['loss']:.6f}, peak {br['peak_bytes'] / 1e9:.2f} "
          f"GB, {br['s']:.3f} s (both with the first call's warm-up)")
    check(abs(kr["loss"] - br["loss"]) <= LLM_LOSS_TOL,
          "starcoder2-3b first step: kernel vs blocked route losses")
    return {"cases": rows, "starcoder2_first_step": route}


def _danube_adam(smi: str) -> dict:
    """(h): ``launch.train --arch h2o-danube-3-4b --steps 3`` with Adam at
    full depth (24 layers): ms per step and the peak, or the
    out-of-memory, recorded."""
    try:
        # 24 layers: the forward and the checkpointed recompute
        return _llm_launch(DANUBE_ADAM, smi, 48)
    except torch.cuda.OutOfMemoryError as e:
        print(f"llm_train (h) launch.train --arch {DANUBE_ADAM} with Adam at "
              f"full depth on {smi}: out of memory "
              f"({str(e).splitlines()[0]})")
        _free_cuda()
        return {"oom": str(e).splitlines()[0]}


def _example_llm(smi: str) -> dict:
    """(i): ``python examples/torch_llm_policy_hts.py --intervals
    EXAMPLE_INTERVALS`` (``main`` in this process), on the card."""
    import importlib.util
    path = ROOT / "examples" / "torch_llm_policy_hts.py"
    spec = importlib.util.spec_from_file_location("torch_llm_policy_hts",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    acc = mod.main(["--intervals", str(EXAMPLE_INTERVALS)])
    wall = time.perf_counter() - t0
    print(f"llm_train (i) examples/torch_llm_policy_hts.py --intervals "
          f"{EXAMPLE_INTERVALS} on {smi}: behavior-policy accuracy {acc}; "
          f"{wall:.1f} s")
    check(len(acc) >= 2 and all(0.0 <= a <= 1.0 for a in acc),
          f"torch_llm_policy_hts accuracies {acc}")
    return {"accuracy": acc, "wall_s": wall}


def phase_llm_train() -> dict:
    """LLM-policy training on the card (phase 10 of the docstring)."""
    import tempfile
    smi = nvidia_smi()
    t0 = time.perf_counter()
    tag = "llm_train"
    res = {"backward": part(tag, "(a) backwards", _llm_backwards)}
    res["backward_times"] = part(tag, "(a) backward times", _bwd_times)
    _free_cuda()
    res["launch"] = {arch: part(tag, f"(b) {arch}", _llm_launch, arch, smi)
                     for arch in LLM_TRAIN}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_llm_") as d:
        res["families"] = {
            arch: part(tag, f"(c) {arch}", _llm_spec_run, arch, smi, Path(d))
            for arch in LLM_SPEC_RUNS}
        res["resume"] = part(tag, "(d) resume", _llm_resume, Path(d))
    res["first_step"] = {
        arch: {dtype: part(tag, f"(c) {arch} {dtype}", _first_step, arch,
                           n_layers, dtype, tol)
               for dtype, tol in (("bfloat16", LLM_LOSS_TOL),
                                  ("float32", CARD_CPU_LOSS_TOL))}
        for arch, n_layers in LLM_FIRST_STEP.items()}
    res["card_vs_cpu"] = part(tag, "(e) card vs CPU", _llm_card_vs_cpu)
    res["launch"]["whisper-medium"] = part(
        tag, "(f) whisper-medium", _modal_train, "whisper-medium", 24, smi,
        WHISPER_TRAIN_FLASH, WHISPER_TRAIN_FLASH_BWD)
    res["launch"]["qwen2-vl-72b"] = part(tag, "(f) qwen2-vl-72b",
                                         _qwen_train, smi)
    res["blocked"] = part(tag, "(g) blocked", _blocked_on_card, smi)
    res["danube_adam"] = part(tag, "(h) danube adam", _danube_adam, smi)
    res["example"] = part(tag, "(i) example", _example_llm, smi)
    print(f"llm_train: phase {time.perf_counter() - t0:.1f} s")
    print("llm_train: " + json.dumps(res, default=str))
    return res


# ------------------------------------------------------- phase_dryrun
# (a): the dry run's own CLI cases on the fake 256-rank pod world
DRYRUN_CASES = (("starcoder2-3b", "train_4k"), ("rwkv6-7b", "decode_32k"))
# (b): the step phase_llm_train times, predicted at world 1
DRYRUN_PEAK_TOL, DRYRUN_FLOPS_TOL = 0.10, 1e-3
# (c): the stream runtime on a live 1-rank mesh: StarCoder2-3B at full
# width, depth cut
MESH_LAYERS, MESH_STEPS = 2, 2


def _dryrun_cli(arch: str, shape: str, out: Path):
    """``python -m repro_torch.launch.dryrun --arch <arch> --shape <shape>
    --mesh pod``, started (not waited for)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "pod", "--out", str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _chip_batch(cfg, B: int, S: int, gen) -> dict:
    """A train batch with ``specs.train_batch_specs``'s keys, on the card."""
    def ints():
        return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device="cuda", dtype=torch.int32)

    def normal():
        return torch.randn(B, S, generator=gen, device="cuda")
    return {"tokens": ints(), "actions": ints(), "advantages": normal(),
            "returns": normal(), "behavior_logprob": normal() - 5.0,
            "loss_mask": torch.ones(B, S, device="cuda")}


def _dryrun_vs_card(smi: str) -> dict:
    """(b): the world-1 dry run of phase_llm_train's StarCoder2-3B step
    (30 layers, 4 x 512 tokens, Adam, bf16, kernels on) against one real
    step on the card: op_cost's FLOPs of the real step, its
    max_memory_allocated, its ms; the roofline's terms; the MFU."""
    from repro_torch.configs.base import get_config
    from repro_torch.core import delayed_grad, learner
    from repro_torch.launch import dryrun, mesh
    from repro_torch.launch.specs import ShapeSpec
    from repro_torch.models import backbone
    from repro_torch.optim import adam
    from repro_torch.roofline import analysis
    from repro_torch.roofline.op_cost import OpCost
    arch = "starcoder2-3b"
    shape = ShapeSpec("llm_train", LLM_SEQ, LLM_BATCH, "train")
    t0 = time.perf_counter()
    pred = dryrun.lower_one(arch, shape, "host", "adam")
    pred_s = time.perf_counter() - t0
    cfg = dataclasses.replace(get_config(arch), use_pallas_attention=True)
    _free_cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = dict(backbone.init_params(cfg, gen, "cuda").named_parameters())
    opt = adam(1e-4)
    dg = delayed_grad.init({k: v.detach() for k, v in params.items()}, opt)
    del params
    batch = _chip_batch(cfg, LLM_BATCH, LLM_SEQ, gen)
    step = learner.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with OpCost() as oc:
        dg, stats = step(dg, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    ms = []
    for _ in range(LLM_STEPS):
        a = time.perf_counter()
        dg, stats = step(dg, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - a) * 1e3)
    check(np.isfinite(float(stats["loss"])), "dry-run step loss")
    pf, rf = pred["cost_loop_aware"]["flops"], oc.flops
    pp = pred["peak_bytes_per_chip"]
    roof = pred["roofline"]
    mf = analysis.model_flops_for(cfg, "train", LLM_SEQ, LLM_BATCH)
    step_ms = float(np.median(ms))
    mfu = analysis.mfu(mf, step_ms / 1e3)
    print(f"dryrun (b) {arch} 4 x 512, Adam, bf16, world 1 on {smi}: "
          f"predicted FLOPs {pf:.6e} vs the card step's op_cost "
          f"{rf:.6e} (rel {abs(pf - rf) / rf:.2e}); predicted peak "
          f"{pp / 1e9:.2f} GB vs max_memory_allocated {peak / 1e9:.2f} GB "
          f"(rel {abs(pp - peak) / peak:.3f}); roofline compute "
          f"{roof['compute_s'] * 1e3:.2f} ms, memory "
          f"{roof['memory_s'] * 1e3:.2f} ms, collective "
          f"{roof['collective_s'] * 1e3:.2f} ms ({roof['bottleneck']}) "
          f"beside the measured {', '.join(f'{x:.1f}' for x in ms)} ms a "
          f"step; model FLOPs {mf:.4e}: MFU {mfu * 100:.2f} % of "
          f"{mesh.PEAK_FLOPS_BF16 / 1e12:.1f} TFLOP/s; flash launches "
          f"{launches['flash_attention']}; prediction {pred_s:.1f} s")
    check(abs(pf - rf) <= DRYRUN_FLOPS_TOL * rf,
          f"dry-run FLOPs {pf} vs the card's {rf}")
    check(abs(pp - peak) <= DRYRUN_PEAK_TOL * peak,
          f"dry-run peak {pp} vs the card's {peak}")
    check(launches["flash_attention"] == LLM_TRAIN[arch],
          f"flash launches {launches}")
    del dg, batch
    _free_cuda()
    return {"pred_flops": pf, "card_flops": rf, "pred_peak": pp,
            "card_peak": peak, "step_ms": ms, "mfu": mfu,
            "model_flops": mf, "roofline": roof, "pred_s": pred_s}


def _live_mesh_worker(port: int) -> None:
    """(c), in its own process: one nccl rank (world 1), the stream
    runtime with ``mesh="host"`` (a live 1-D data mesh over that world)
    and with no mesh, StarCoder2-3B at full width and MESH_LAYERS layers;
    prints the comparison as JSON."""
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.configs.base import get_config
    from repro_torch.core.engine import HTSConfig
    from repro_torch.core.stream_runtime import StreamRuntime
    from repro_torch.data.pipeline import TokenStream
    from repro_torch.models import backbone
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    torch.cuda.set_device(0)
    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              n_layers=MESH_LAYERS, use_pallas_attention=True)
    params = dict(backbone.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0),
        "cuda").named_parameters())
    out = {}
    for mesh in (None, "host"):
        zero_launches()
        rt = StreamRuntime(
            lambda: TokenStream(cfg.vocab_size, LLM_BATCH, LLM_SEQ, 0,
                                device="cuda"),
            params, optim.get_optimizer("adam", lr=1e-4), HTSConfig(), cfg,
            mesh=mesh, device="cuda")
        res = rt.run(MESH_STEPS)
        whole = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                 for k, v in res.params.items()}
        out[str(mesh)] = {"params": {k: v.cpu() for k, v in whole.items()},
                          "loss": res.metrics["loss"].tolist(),
                          "launches": read_launches(),
                          "mesh": str(rt.mesh),
                          "type": type(next(iter(res.params.values())))
                          .__name__}
        del rt, res, whole
        _free_cuda()
    a, b = out["None"], out["host"]
    equal = all(torch.equal(a["params"][k], b["params"][k])
                for k in a["params"])
    worst = max((a["params"][k].float() - b["params"][k].float()).abs()
                .max().item() for k in a["params"])
    print("MESH " + json.dumps({
        "equal": equal, "max_abs": worst, "loss_none": a["loss"],
        "loss_mesh": b["loss"], "launches_none": a["launches"],
        "launches_mesh": b["launches"], "mesh": b["mesh"],
        "types": [a["type"], b["type"]]}))
    dist.destroy_process_group()


def _live_mesh(smi: str) -> dict:
    """(c): ``_live_mesh_worker`` in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke as c; c._live_mesh_worker({_free_port()})"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    line = [x for x in proc.stdout.splitlines() if x.startswith("MESH ")]
    check(proc.returncode == 0 and line,
          f"live mesh worker: {proc.stderr[-3000:]}")
    mesh = json.loads(line[-1][len("MESH "):])
    print(f"dryrun (c) stream runtime, StarCoder2-3B full width, "
          f"{MESH_LAYERS} layers, {MESH_STEPS} steps on {smi}: a live "
          f"1-rank mesh ({mesh['mesh']}, nccl; params {mesh['types'][1]}) "
          f"vs no mesh: torch.equal {mesh['equal']} (max |diff| "
          f"{mesh['max_abs']}), losses {mesh['loss_mesh']} vs "
          f"{mesh['loss_none']}, flash launches {mesh['launches_mesh']} vs "
          f"{mesh['launches_none']}")
    check(mesh["equal"], "live 1-rank mesh params differ from no mesh")
    check(mesh["types"] == ["Tensor", "DTensor"], f"types {mesh['types']}")
    check(mesh["launches_mesh"]["flash_attention"] > 0
          and mesh["launches_mesh"] == mesh["launches_none"],
          "flash under local_map")
    return mesh


def _pod_result(arch: str, shape: str, proc, started: float, out_dir: Path,
                smi: str) -> dict:
    """(a): one dry-run CLI process's ``[OK]`` line and artifact."""
    stdout, stderr = proc.communicate(timeout=900)
    secs = time.perf_counter() - started
    lines = [x for x in stdout.splitlines() if x.startswith("[")]
    check(proc.returncode == 0 and lines and lines[0].startswith("[OK]"),
          f"dry run {arch} {shape}: {stdout[-2000:]} {stderr[-3000:]}")
    art = json.loads((out_dir / f"{arch}__{shape}__pod.json").read_text())
    print(f"dryrun (a) {lines[0]} | peak/chip "
          f"{art['peak_bytes_per_chip'] / 1e9:.2f} GB, fits_80g "
          f"{art['fits_80g']}, bottleneck {art['roofline']['bottleneck']}, "
          f"{secs:.1f} s on this machine's CPU; {smi}")
    return {"peak": art["peak_bytes_per_chip"], "fits_80g": art["fits_80g"],
            "bottleneck": art["roofline"]["bottleneck"],
            "collectives": art["collectives"]["bytes_by_op"], "s": secs}


def phase_dryrun() -> dict:
    """(a) the dry run's CLI on the fake 256-rank world (two cases, in
    subprocesses started first, run beside (b) and (c)); (b) the world-1
    prediction against the card; (c) the stream runtime on a live 1-rank
    mesh. Every part runs; the phase fails after, naming each failure."""
    smi = nvidia_smi()
    t0 = time.perf_counter()
    out_dir = ROOT / "artifacts" / "dryrun_torch"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {(a, s): (_dryrun_cli(a, s, out_dir), time.perf_counter())
             for a, s in DRYRUN_CASES}
    res, failed = {"pod": {}}, []
    parts = [("vs_card", _dryrun_vs_card, (smi,)),
             ("live_mesh", _live_mesh, (smi,))]
    parts += [(f"{a} {s}", _pod_result, (a, s, p, t, out_dir, smi))
              for (a, s), (p, t) in procs.items()]
    for name, fn, args in parts:
        try:
            out = fn(*args)
        except Exception as e:      # report every part before failing
            failed.append(f"{name}: {e}")
            print(f"dryrun: {name} FAILED: {e}", flush=True)
            continue
        if name in ("vs_card", "live_mesh"):
            res[name] = out
        else:
            res["pod"][name] = out
    print(f"dryrun: phase {time.perf_counter() - t0:.1f} s")
    print("dryrun: " + json.dumps(res, default=str))
    check(not failed, "; ".join(failed))
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
    timed("dryrun", phase_dryrun)

    smi = nvidia_smi()
    print(f"times on {smi}:")
    for arch, run in runs.items():
        print(f"  {arch} prefill {BATCH}x{PROMPT} {run['prefill_ms']:.3f} "
              f"ms, decode {run['tok_s']:.1f} tok/s ({BATCH} rows x "
              f"{GEN - 1} steps, sampled; the launcher's second, warm run)")
    times = timed("times", lambda: {
        "flash_attention": [flash_times(c) for c in PREFILL_ATTN],
        "lru_scan": lru_times(),
        "wkv6": [wkv_times(WKV_MAIN), wkv_times(WKV_DECODE)]})
    print("phase seconds: " + json.dumps(seconds))
    print(json.dumps({"kernels": [
        _bwd_entry(k, runs, llm) if k.endswith("_bwd")
        else _entry(k, runs, errs[k], times[k], llm) for k in SOURCES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
