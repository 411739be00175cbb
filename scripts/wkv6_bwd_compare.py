"""The wkv6 backward binding's time, and its split by kernel, at RWKV-6's
training shape (``chip_smoke.WKV_TRAIN``: B 4, T 512, H 64, N 64, bf16)
and at a ragged (4, 500, 64, 64) bf16 one, for one or more source trees,
each in a fresh process, in the order given:

    python3 scripts/wkv6_bwd_compare.py PARENT/src src src PARENT/src

where PARENT is a ``git archive`` of an earlier commit unpacked in a
directory that ``.gitignore`` lists. Each tree builds its own kernels
(under its own ``build/``). Inputs come from one seed as
``chip_smoke.wkv_inputs`` makes them (w fp32, s0), with N(0, 1)
cotangents (do in bf16, ds_T fp32); the binding ``kernel.wkv6_bwd`` is
timed by ``chip_smoke.cuda_ms`` (CUDA events, 10 calls after 2) and split
by ``chip_smoke.kernel_split`` (torch.profiler's kernel events, the mean
launch of 50 calls).
Prints the card's name and power limit, one line per run, and each tree's
mean per shape. Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4, 512, 64, 64), (4, 500, 64, 64))


def child(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from repro_torch.kernels.wkv6 import kernel as wk
    sys.path.insert(1, str(ROOT))
    import chip_smoke as c   # its repro_torch import finds the tree's
    wk.bwd_library()
    gen = torch.Generator(device="cuda").manual_seed(11)
    ms, split = [], []
    for shape in SHAPES:
        r, k, v, w, u, s0 = c.wkv_inputs((*shape, torch.bfloat16), gen)
        do = torch.randn(r.shape, generator=gen, device="cuda").to(r.dtype)
        ds_T = torch.randn(s0.shape, generator=gen, device="cuda")

        def call():
            return wk.wkv6_bwd(r, k, v, w, u, s0, do, ds_T)
        ms.append(c.cuda_ms(call, 10, 2))
        split.append(c.kernel_split(call))
    print("RUN " + json.dumps({"tree": tree, "ms": ms, "split_us": split}))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--child"]:
        child(argv[1])
        return 0
    if not argv:
        print(__doc__)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    runs: dict = {}
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--child", tree],
                              capture_output=True, text=True)
        line = next((ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RUN ")), None)
        if proc.returncode or line is None:
            print(f"{tree}: failed ({proc.returncode})\n{proc.stderr[-3000:]}")
            return 1
        run = json.loads(line[4:])
        runs.setdefault(tree, []).append(run["ms"])
        for shape, t, split in zip(SHAPES, run["ms"], run["split_us"]):
            parts = ", ".join(f"{n} {us:.1f}" for n, us in sorted(
                split.items(), key=lambda kv: -kv[1])) or "not measured"
            print(f"{tree} {shape}: {t:.4f} ms; by kernel (us a call): "
                  f"{parts}")
    for tree, rows in runs.items():
        mean = [sum(col) / len(col) for col in zip(*rows)]
        print(f"mean {tree} ({len(rows)} runs): "
              + json.dumps([round(t, 4) for t in mean]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
