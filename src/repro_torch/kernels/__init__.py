"""Hand-written Hopper kernels, their plain PyTorch versions, and the
rule that picks between them.

Each kernel package has the reference's three layers:

  kernel.py  — the ctypes binding of a CUDA C++ kernel under ``csrc/``;
  ref.py     — the plain PyTorch version of the same function;
  ops.py     — the public wrapper (layouts, padding, routing).

Routing (counterpart of ``repro/kernels/__init__.py::resolve_backend``):
a CPU tensor takes the plain version, as the reference runs Pallas in
interpret mode off the TPU; a CUDA tensor takes the kernel, or raises if
the kernel cannot be built or launched. The plain version runs on the
card only when the caller asks for it with ``use_kernel=False``.

Kernels are built at first use by ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers), keyed on a hash of the sources
and flags, under ``build/repro_torch_kernels/`` at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCKS: dict = {}
_LOCK = threading.Lock()


def use_kernel_for(x: torch.Tensor, use_kernel: bool) -> bool:
    """True when ``x`` must go through the hand-written kernel."""
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return use_kernel
    raise ValueError(f"no kernel route for device {x.device}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def source_digest(source: Path) -> str:
    """Hash of every file under the source's directory (the ``.cu`` and
    any header it includes) and of the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in source.parent.rglob("*") if p.is_file()):
        h.update(f.relative_to(source.parent).as_posix().encode() + b"\0")
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build(name: str, source: Path) -> Path:
    """Compile ``source`` into ``BUILD_DIR/<name>-<hash>.so`` unless that
    file exists already; returns its path. The hash covers the whole
    ``csrc/`` directory and the flags (``source_digest``). The compiler's
    report (registers, shared memory, spills) lands beside it as ``.log``."""
    digest = source_digest(source)
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source} ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: a concurrent builder sees all or nothing
    return out


def load(name: str, source: Path) -> ctypes.CDLL:
    """Build (if needed) and ``dlopen`` a kernel library, once per process.
    One lock per library, so threads can build different ones at once."""
    with _LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name, source)))
        return _LIBS[name]
