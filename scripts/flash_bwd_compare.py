"""The flash attention backward binding's time at every training shape of
``chip_smoke.py`` (``TRAIN_FLASH``'s last 11: B 4, S 512; Whisper's
encoder at 1500 and its cross-attention 512 against 1500), for one or
more source trees, each in a fresh process, in the order given:

    python3 scripts/flash_bwd_compare.py PARENT/src src src PARENT/src

where PARENT is a ``git archive`` of an earlier commit unpacked in a
directory that ``.gitignore`` lists. Each tree builds its own kernels
(under its own ``build/``). Inputs come from one seed, the forward
kernel's output and lse, as ``chip_smoke._flash_bwd_shapes`` makes them,
and are timed by ``chip_smoke.cuda_ms`` (CUDA events, 10 calls after 2).
Prints the card's name and power limit, one line per run, and each
tree's mean per shape. Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(tree: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from repro_torch.kernels.flash_attention import kernel as fk
    sys.path.insert(1, str(ROOT))
    import chip_smoke as c   # its repro_torch import finds the tree's
    fk.library()
    fk.bwd_library()
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = []
    for case in c.TRAIN_FLASH[-len(c.PREFILL_ATTN):]:
        B, S, H, KV, Dh, causal, window, cap, *_, dt = case[:11]
        q, k, v = c.flash_inputs(case, gen)
        kw = dict(causal=causal, window=window, cap=cap)
        o, lse = fk.flash_attention(q, k, v, lse=True, **kw)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
        out.append(c.cuda_ms(lambda: fk.flash_attention_bwd(
            q, k, v, o, lse, do, **kw), 10, 2))
    print("RUN " + json.dumps({"tree": tree, "ms": out}))


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
        ms = json.loads(line[4:])["ms"]
        runs.setdefault(tree, []).append(ms)
        print(f"{tree}: " + " ".join(f"{t:.4f}" for t in ms))
    for tree, rows in runs.items():
        mean = [sum(col) / len(col) for col in zip(*rows)]
        print(f"mean {tree} ({len(rows)} runs): "
              + json.dumps([round(t, 4) for t in mean]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
