"""The flash attention backward kernel on the card against two yardsticks:
the plain version in bf16 (what ``chip_smoke.py`` phase 10 (a) holds it
to, at 3e-2) and an fp32 witness (the plain version on the same bf16
inputs cast to fp32). Per seed and gradient: the largest distance of each
to the witness, whether the kernel passes the witness check of phase 10
(a) (no further from the witness than the plain version, or within 3e-2
of it), the elements past the 3e-2 check against the plain version (with
the worst ones' three values), and the binding's time. The bf16 kernel
feeds P and dS to their products as two bf16 halves each; a kernel that
rounds either once must pass both checks on every seed at both shapes
(with P rounded once, one dV element a shape failed the check against the
plain version, PERF.md).

    python3 scripts/flash_bwd_witness.py [--seeds 4] [--shape starcoder2|recurrentgemma]

Needs a CUDA card; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels.flash_attention import kernel, ops  # noqa: E402

# (B, S, H, KV, Dh, window): the training shapes of chip_smoke.py
SHAPES = {"starcoder2": (4, 512, 24, 2, 128, 0),
          "recurrentgemma": (4, 512, 16, 1, 256, 2048)}
TOL = 3e-2


def grads(fn, xs, cot):
    xs = [x.detach().clone().requires_grad_() for x in xs]
    return torch.autograd.grad(fn(*xs), xs, cot)


def cuda_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--shape", default="starcoder2", choices=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_witness: needs a CUDA card", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H, KV, Dh, window = SHAPES[args.shape]
    kw = dict(causal=True, window=window)
    failed = 0
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn(B, S, H, Dh, generator=gen, device="cuda")
        k, v = (torch.randn(B, S, KV, Dh, generator=gen, device="cuda")
                for _ in range(2))
        cot = torch.randn(B, S, H, Dh, generator=gen, device="cuda")
        xs = [t.bfloat16() for t in (q, k, v)]
        witness = grads(lambda *x: ops.attend(*x, use_kernel=False, **kw),
                        [t.float() for t in xs], cot.bfloat16().float())
        plain = grads(lambda *x: ops.attend(*x, use_kernel=False, **kw), xs,
                      cot.bfloat16())
        got = grads(lambda *x: ops.attend(*x, **kw), xs, cot.bfloat16())
        for name, g, p, w in zip("qkv", got, plain, witness):
            g, p, w = g.float(), p.float(), w.float()
            bad = ((g - p).abs() > TOL + TOL * p.abs()).nonzero().tolist()
            dk, dp = ((x - w).abs().max().item() for x in (g, p))
            near = dk <= dp or torch.allclose(g, w, atol=TOL, rtol=TOL)
            failed += bool(bad) + (not near)
            print(f"seed {seed} d{name}: kernel vs fp32 witness max "
                  f"{dk:.3e}, plain bf16 vs witness {dp:.3e} (witness "
                  f"check {'ok' if near else 'FAILED'}); {len(bad)} past "
                  f"the {TOL} check against the plain version"
                  + "".join(f"; at {tuple(i)} kernel {g[tuple(i)].item():.6f}"
                            f" plain {p[tuple(i)].item():.6f} witness "
                            f"{w[tuple(i)].item():.6f}" for i in bad[:3]))
    o, lse = kernel.flash_attention(*xs, lse=True, **kw)
    do = cot.bfloat16()
    ms = cuda_ms(lambda: kernel.flash_attention_bwd(*xs, o, lse, do, **kw))
    print(f"backward binding at {SHAPES[args.shape]}: {ms:.4f} ms")
    print(f"checks failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
