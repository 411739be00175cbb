"""The lru_scan backward kernel's tile shape on the card: the TMA kernel
built from copies of ``csrc/`` with other steps per tile (``kSteps``,
shared with the forward in ``tma_ring.cuh``) and stages in the ring
(``kStages`` in ``lru_scan_bwd.cu``), each held bit for bit against the
committed build and timed, in turns, at RecurrentGemma-9B's training
shape (4, 512, 4096) fp32.

    python3 scripts/lru_scan_bwd_tiles.py

Needs a CUDA card and nvcc; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.lru_scan import kernel  # noqa: E402

# (steps per tile, stages): the committed shape first
TILES = [(32, 3), (32, 2), (16, 4), (16, 6), (64, 1)]
SHAPE = (4, 512, 4096)


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
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


def build(src: Path, tmp: Path, steps: int, stages: int) -> ctypes.CDLL:
    """The backward library from a copy of ``src`` with the tile shape
    replaced."""
    d = tmp / f"s{steps}_k{stages}"
    shutil.copytree(src, d)
    for name, old, new in (
            ("tma_ring.cuh", "constexpr int kSteps = 32;",
             f"constexpr int kSteps = {steps};"),
            ("lru_scan_bwd.cu", "constexpr int kStages = 3;",
             f"constexpr int kStages = {stages};")):
        text = (d / name).read_text()
        if old not in text:
            raise RuntimeError(f"{name}: no '{old}' to replace")
        (d / name).write_text(text.replace(old, new))
    out = d / "lib.so"
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out),
                    str(d / "lru_scan_bwd.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    lib.repro_lru_scan_bwd.argtypes = ([ctypes.c_void_p] * 8
                                       + [ctypes.c_int] * 6
                                       + [ctypes.c_void_p])
    lib.repro_lru_scan_bwd.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.sigmoid(torch.randn(SHAPE, generator=gen, device="cuda"))
    b, gy = (torch.randn(SHAPE, generator=gen, device="cuda")
             for _ in range(2))
    h0, ghl = (torch.randn(SHAPE[::2], generator=gen, device="cuda")
               for _ in range(2))
    y, _ = kernel.lru_scan(a, b, h0)
    want = kernel.lru_scan_bwd(a, h0, y, gy, ghl, b.dtype)
    stream = torch.cuda.current_stream().cuda_stream
    calls = {}
    with tempfile.TemporaryDirectory() as tmp:
        for steps, stages in TILES:
            lib = build(kernel.BWD_SOURCE.parent, Path(tmp), steps, stages)
            outs = [torch.empty_like(t) for t in want]

            def call(lib=lib, outs=outs):
                err = lib.repro_lru_scan_bwd(
                    a.data_ptr(), h0.data_ptr(), y.data_ptr(), gy.data_ptr(),
                    ghl.data_ptr(), *(t.data_ptr() for t in outs), *SHAPE,
                    0, 0, 1, stream)
                kernels.raise_on_error(lib, err, "lru_scan backward kernel")
            call()
            torch.cuda.synchronize()
            equal = all(torch.equal(o, w) for o, w in zip(outs, want))
            print(f"{steps} steps x {stages} stages: torch.equal to the "
                  f"committed build {equal}")
            if not equal:
                return 1
            calls[(steps, stages)] = call
        reads = {tile: [] for tile in calls}
        for tile in [*calls, *reversed(calls)]:
            reads[tile].append(cuda_ms(calls[tile]))
    for (steps, stages), ms in reads.items():
        print(f"lru_scan backward, TMA kernel, {steps} steps x {stages} "
              f"stages at {list(SHAPE)} fp32: "
              + ", ".join(f"{x:.4f}" for x in ms) + " ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
