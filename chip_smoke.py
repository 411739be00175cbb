"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. the card: nvidia-smi name and power limit, torch and CUDA versions;
2. the build: every hand-written kernel of the serving path, by nvcc;
3. each kernel against its plain PyTorch version on the card, at the
   reference test cases and at the shape the main path gives it;
4. the main path: ``repro_torch.launch.serve.main`` for StarCoder2-3B at
   full width (30 layers, d_model 3072, random bf16 weights from a seed),
   4 prompts of 500 tokens, 32 generated. The kernel launch counts are
   zeroed just before and read just after; the prefill logits are held
   against the same weights run with plain attention, a sampled run is
   repeated to show its tokens do not change, and a reduced fp32 config
   is held against the CPU run of the same weights;
5. times, beside the card's name and power limit: prefill, decode, and
   each kernel's time against its bound, its plain version and the
   library call that computes the same function.

The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Needs CUDA; imports nothing of jax.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and FLOP/s by input type
# (bf16 on the tensor cores; fp32 on the CUDA cores).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# (B, S, H, KV, Dh, causal, window, cap, bq, bk, dtype): the reference's
# FLASH_CASES (tests/test_kernels.py), padded and Dh=256 cases, and the
# main path's prefill shape (S=500 pads to 512 with kv_len=500).
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
MAIN = (4, 500, 24, 2, 128, True, 0, 0.0, 128, 128, torch.bfloat16)
GEN = 32
SERVE_ARGV = ["--arch", "starcoder2-3b", "--batch", str(MAIN[0]),
              "--prompt-len", str(MAIN[1]), "--gen", str(GEN)]
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile_window(label: str, fn) -> None:
    """Device busy share and the top kernels of one window, from
    torch.profiler's kernel events (times under the profiler)."""
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
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
    busy_us = sum(by_name.values())
    if not busy_us:
        print(f"profile {label}: wall {wall_us / 1e3:.3f} ms; device time "
              "not measured (the profiler recorded no kernels)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, kernels "
          f"{busy_us / 1e3:.3f} ms (device busy {100 * busy_us / wall_us:.1f}"
          "%); top: " + "; ".join(f"{n[:60]} {t / 1e3:.3f} ms"
                                  for n, t in top))


def flash_inputs(case, gen):
    B, S, H, KV, Dh, *_, dt = case
    return [torch.randn(shape, generator=gen, device="cuda").to(dt)
            for shape in ((B, S, H, Dh), (B, S, KV, Dh), (B, S, KV, Dh))]


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
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    t0 = time.perf_counter()
    lib = fa_kernel.library()
    print(f"build: flash_attention.cu by nvcc for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s -> {Path(lib._name).name}")
    log = Path(lib._name).with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())


def phase_kernels() -> float:
    """Every case: kernel vs plain version on the card. Returns the error
    at the main path's shape."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, main_err = [], None
    for case in FLASH_CASES + [MAIN]:
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
        if case is MAIN:
            main_err = err
    print("flash_attention vs plain version on the card: "
          + json.dumps({"name": "flash_attention", "cases": cases,
                        "max_abs_err": max(c["max_abs_err"] for c in cases),
                        "launches": fa_kernel.launches}))
    return main_err


def phase_main_path() -> dict:
    """The serving path at full width; returns its launch counts and
    steady-state times."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.launch import serve
    from repro_torch.models import backbone

    fa_kernel.launches = 0
    res = serve.main(SERVE_ARGV)
    launches = {"flash_attention": fa_kernel.launches}
    cfg = res.cfg
    B, S = res.prompts.shape
    print(f"main path: {cfg.name} n_layers={cfg.n_layers} "
          f"d_model={cfg.d_model} dtype={cfg.dtype}; launches {launches}")
    check(launches["flash_attention"] == cfg.n_layers == 30,
          f"expected 30 flash_attention launches in the prefill: {launches}")
    check(res.prefill_logits.shape == (B, cfg.vocab_size)
          and bool(torch.isfinite(res.prefill_logits).all()),
          "prefill logits finite and (B, vocab)")
    check(res.tokens.shape == (B, GEN) and int(res.tokens.min()) >= 0
          and int(res.tokens.max()) < cfg.vocab_size, "generated tokens")

    plain_cfg = dataclasses.replace(cfg, use_pallas_attention=False)
    with torch.inference_mode():
        plain_logits, _, _ = backbone.prefill(res.model, plain_cfg,
                                              res.prompts, S + GEN)
    check(fa_kernel.launches == launches["flash_attention"],
          "the plain-attention run launched the kernel")
    rel = ((res.prefill_logits - plain_logits).abs().max()
           / plain_logits.abs().max()).item()
    print(f"prefill logits, kernel vs plain attention (same weights): "
          f"relative max error {rel:.3e} (bound 5e-2)")
    check(rel < 5e-2, "prefill logits vs plain attention")

    prefill_ms, tok_s = [], []
    for _ in range(3):
        _, _, p_s, d_s = serve.generate(res.model, cfg, res.prompts, GEN)
        prefill_ms.append(p_s * 1e3)
        tok_s.append(B * (GEN - 1) / d_s)
    with torch.inference_mode():
        profile_window("prefill", lambda: backbone.prefill(
            res.model, cfg, res.prompts, S + GEN))
        _, _, cache = backbone.prefill(res.model, cfg, res.prompts, S + GEN)
        tok = res.tokens[:, :1]
        profile_window("decode, 8 steps", lambda: [
            backbone.decode_step(res.model, cfg, tok, cache, S + i)
            for i in range(8)])
    del res, plain_logits, cache
    torch.cuda.empty_cache()

    tokens = []
    for _ in range(2):
        run = serve.main(SERVE_ARGV + ["--temperature", "1.0", "--seed", "3"])
        tokens.append(run.tokens.clone())
        del run
        torch.cuda.empty_cache()
    check(torch.equal(*tokens), "sampled rerun gave other tokens")
    print("sampled rerun (temperature 1.0, seed 3): identical tokens")

    small_cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    small, prompts = serve.build(small_cfg, 2, 150, torch.device("cuda"))
    g_logits, g_tokens, _, _ = serve.generate(small, small_cfg, prompts, 6)
    c_logits, c_tokens, _, _ = serve.generate(small.to("cpu"), small_cfg,
                                              prompts.cpu(), 6)
    err = (g_logits.cpu() - c_logits).abs().max().item()
    same = torch.equal(g_tokens.cpu(), c_tokens)
    print(f"reduced fp32 (2 layers, prompt 150): card vs CPU prefill logits "
          f"max abs err {err:.3e} (tol 1e-4); greedy tokens equal {same}")
    check(err < 1e-4 and same, "reduced model: card vs CPU")
    return {"launches": launches, "prefill_ms": prefill_ms, "tok_s": tok_s}


def flash_times() -> dict:
    """The kernel at the main path's shape (after the wrapper's padding)
    against its bound, the plain version and SDPA."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, Sq, H, KV, Dh, causal, *_, dt = MAIN
    q, k, v = flash_inputs(MAIN, torch.Generator(device="cuda").manual_seed(1))
    Sp = -(-Sq // 128) * 128
    qt, kt, vt = (F.pad(x.transpose(1, 2), (0, 0, 0, Sp - Sq)).contiguous()
                  for x in (q, k, v))
    kw = dict(causal=causal, window=0, cap=0.0, kv_len=Sq)
    ms = cuda_ms(lambda: fa_kernel.flash_attention(qt, kt, vt, **kw))
    plain_ms = cuda_ms(lambda: flash_attention_ref(qt, kt, vt, **kw))
    try:
        F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)

        def lib_call():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
    except TypeError:  # torch without enable_gqa: expand kv heads first
        kx, vx = (x.repeat_interleave(H // KV, dim=1) for x in (kt, vt))

        def lib_call():
            return F.scaled_dot_product_attention(qt, kx, vx, is_causal=True)
    library_ms = cuda_ms(lib_call)

    # the work this call's masks leave: (query, key) pairs causal and < kv_len
    qpos = torch.arange(Sp, device="cuda")[:, None]
    kpos = torch.arange(Sp, device="cuda")[None, :]
    pairs = int(((kpos <= qpos) & (kpos < Sq)).sum())
    n_bytes = sum(x.numel() * x.element_size() for x in (qt, kt, vt, qt))
    n_ops = 4 * B * H * pairs * Dh
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dt] * 1e3
    print(f"  flash_attention (B={B} H={H} KV={KV} S={Sp} kv_len={Sq} "
          f"Dh={Dh} {dt} causal): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, SDPA {library_ms:.4f} ms; bound {max(t_bytes, t_ops):.4f} ms "
          f"({n_bytes} bytes -> {t_bytes:.4f} ms, {n_ops} FLOP -> "
          f"{t_ops:.4f} ms)")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    name = phase_card()
    phase_build()
    main_err = phase_kernels()
    run = phase_main_path()

    smi = nvidia_smi()
    print(f"times on {smi}:")
    print(f"  prefill {MAIN[0]}x{MAIN[1]} ms (3 runs): "
          + ", ".join(f"{x:.3f}" for x in run["prefill_ms"]))
    print(f"  decode tok/s, {MAIN[0]} rows x {GEN - 1} steps (3 runs): "
          + ", ".join(f"{x:.1f}" for x in run["tok_s"]))
    times = flash_times()
    print(json.dumps({"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:88",
        "launches": run["launches"]["flash_attention"],
        "max_abs_err": main_err, **times}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
