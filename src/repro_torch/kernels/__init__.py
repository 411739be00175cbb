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

On the CUDA route each wrapper calls its kernel inside a
``torch.autograd.Function`` (``setup_context`` style, with a ``vmap``
rule, ``vmap_by_folding``), so ``.backward()``, ``torch.func.grad``,
``vjp`` and ``vmap`` all work on the kernels' outputs. Each backward is
a kernel too: each kernel's own backward kernel, called through a
``Function`` of its own, so ``vmap`` of a gradient folds it too. The
reference differentiates its oracles (``custom_vjp``); the backward
kernels compute the same gradients. The CPU route differentiates through
the plain version.

Two more routes, neither of which launches anything on a CPU tensor or
hides the card. A ``FakeTensor`` (the dry run's shape propagation,
``launch/dryrun.py``) takes the binding's fake branch: the kernel's
outputs are allocated with the shapes and dtypes it writes, and nothing
is launched or counted. A ``DTensor`` takes ``per_shard``, which runs
the wrapper on each rank's local shards through ``local_map`` (batch on
the data axes, heads or channels on ``model``), so a local CUDA shard
still takes the kernel. ``notify`` tells a cost counter
(``roofline/op_cost.py``) of each kernel call, real or fake, with its
FLOPs: a ctypes launch is invisible to a dispatch mode.

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
    """True when ``x`` must go through the hand-written kernel. A
    ``FakeTensor`` on any device takes the kernel's fake route (shapes
    only: nothing runs)."""
    if is_fake(x):
        return use_kernel
    if x.device.type == "cpu":
        return False
    if x.device.type == "cuda":
        return use_kernel
    raise ValueError(f"no kernel route for device {x.device}")


def is_fake(x) -> bool:
    """True for a ``FakeTensor``: shapes only, no storage to launch on."""
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(x, FakeTensor)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


# cost counters listening to kernel calls (``roofline.op_cost.OpCost``)
LISTENERS: list = []


def notify(name: str, inputs, outputs, flops: float,
           transcendentals: float = 0.0) -> None:
    """Report one kernel call (real or fake) to the active listeners."""
    for listener in LISTENERS:
        listener(name, [t for t in inputs if t is not None], list(outputs),
                 flops, transcendentals)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a
    ``DTensor`` built from a local gradient claims contiguous strides
    whatever the local tensor's are (a plain version's VJP may return a
    transposed one), and a later view of it would fail."""

    @staticmethod
    def forward(x):
        return x

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def per_shard(fn, args, specs, out_specs):
    """``fn`` on each rank's shards of the ``DTensor`` arguments: the
    ``local_map`` of ``fn`` with each argument redistributed to its spec
    (``sharding.rules.P``; ``None`` for a non-tensor argument) and the
    outputs assembled under ``out_specs``. The mesh is the first
    ``DTensor`` argument's."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.sharding.rules import to_placements
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    # absent (None) arguments stay out of local_map's flattening
    keep = [i for i, a in enumerate(args) if a is not None]

    def local(*present):
        full = [None] * len(args)
        for i, a in zip(keep, present):
            full[i] = (_ContiguousGrad.apply(a)
                       if isinstance(a, torch.Tensor) and a.requires_grad
                       else a)
        return fn(*full)

    in_pl = tuple(None if specs[i] is None
                  else to_placements(specs[i], mesh) for i in keep)
    out_pl = tuple(to_placements(s, mesh) for s in out_specs)
    if len(out_pl) == 1:
        # one output: its placements as a list (a tuple means outputs)
        out_pl = list(out_pl[0])
    return local_map(local, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(
        *(args[i] for i in keep))


def split_axes(x, batch: int, *counts):
    """(the batch dim's data axes or None, ``"model"`` or None) for a
    kernel call on ``x``'s mesh: ``model`` splits the heads (channels)
    only when it divides every count in ``counts``, so each shard holds
    whole heads and whole GQA groups."""
    from repro_torch.launch.mesh import axis_sizes
    from repro_torch.sharding.rules import batch_pspec
    mesh = x.device_mesh
    m = axis_sizes(mesh).get("model")
    model = "model" if m and all(c % m == 0 for c in counts) else None
    return batch_pspec(mesh, batch), model


def vmap_by_folding(apply, info, in_dims, args, batched):
    """The ``vmap`` rule of a kernel's ``autograd.Function``: the kernels
    take a leading batch axis, so a vmapped call folds the vmapped axis
    into it (one launch) and splits it off the outputs. ``batched[i]``
    says whether ``args[i]`` has that leading batch axis; an argument
    without one (wkv6's ``u``) that is vmapped itself makes the rule call
    once per vmapped index and stack. ``None`` arguments and options pass
    through."""
    n = info.batch_size
    if any(d is not None and not b for d, b in zip(in_dims, batched)):
        outs = []
        for i in range(n):
            sub = [a if d is None else a.select(d, i)
                   for a, d in zip(args, in_dims)]
            outs.append(apply(*sub))
        outs = tuple(torch.stack(o) for o in zip(*outs))
        return outs, (0,) * len(outs)
    folded, lead = [], None
    for a, d, b in zip(args, in_dims, batched):
        if b and a is not None:
            a = a.movedim(d, 0) if d is not None else a.expand(n, *a.shape)
            lead = a.shape[1]
            a = a.reshape(n * a.shape[1], *a.shape[2:])
        folded.append(a)
    outs = apply(*folded)
    outs = tuple(o.reshape(n, lead, *o.shape[1:]) for o in outs)
    return outs, (0,) * len(outs)


def raise_on_error(lib, err: int, what: str) -> None:
    """Raise if a kernel library's entry point returned an error: a
    ``cudaError_t`` (the launch was refused or failed) or a negative code
    of the library's own (a refused TMA map); ``lib`` names the error."""
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()} "
                           f"(code {err})")


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
