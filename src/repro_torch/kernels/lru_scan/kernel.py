"""ctypes binding of the hand-written LRU scan kernel.

Counterpart of ``repro/kernels/lru_scan/kernel.py::lru_scan`` (the Pallas
TPU kernel). The CUDA C++ source is ``csrc/lru_scan.cu``, built by
``nvcc`` for ``sm_90a`` at first use (``repro_torch.kernels.load``). Its
entry point launches one of two kernels per call, the one ``use_tma``
picks: the TMA ring (16-byte aligned bases and rows, every model shape) or
the per-thread kernel (any shape). This wrapper checks what the kernel
takes, allocates the outputs, launches on PyTorch's current stream and
raises if the launch is refused. It takes CUDA tensors only: the CPU goes
through ``ref.py`` (see ``ops.scan``).

A ``FakeTensor`` (the dry run) is checked the same way and gets its
outputs allocated, with no launch.

The backward, ``lru_scan_bwd``, is a second library from
``csrc/lru_scan_bwd.cu`` (one reverse-time pass: the forward's TMA ring
walked from the last tile to the first, and a per-thread kernel for the
shapes TMA refuses), bound the same way; ``use_tma_bwd`` picks its kernel.

``launches`` and ``bwd_launches`` count the forward's and the backward's
launches in this process, ``tma_launches`` and ``bwd_tma_launches`` those
of them that took the TMA kernel; callers that want to show a path went
through the kernels set them to 0 and read them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import kernels

SOURCE = Path(__file__).parent / "csrc" / "lru_scan.cu"
BWD_SOURCE = Path(__file__).parent / "csrc" / "lru_scan_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
tma_launches = 0
bwd_launches = 0
bwd_tma_launches = 0


@functools.cache
def library() -> ctypes.CDLL:
    lib = kernels.load("lru_scan", SOURCE)
    fn = lib.repro_lru_scan_fwd
    # (a, b, h0 or NULL, y, h_last, B, S, D, a_dtype, b_dtype, use_tma,
    #  stream)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def bwd_library() -> ctypes.CDLL:
    lib = kernels.load("lru_scan_bwd", BWD_SOURCE)
    fn = lib.repro_lru_scan_bwd
    # (a, h0 or NULL, y, gy, gh_last, da, db, dh0 or NULL, B, S, D,
    #  a_dtype, b_dtype, use_tma, stream)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _tma_takes(D: int, *operands) -> bool:
    """TMA takes a base and a row stride (D * element size) that are
    multiples of 16 bytes; ``operands`` are (dtype, base address) pairs."""
    return all(dt in _DTYPES and (D * dt.itemsize) % 16 == 0 and ptr % 16 == 0
               for dt, ptr in operands)


def use_tma(a_dtype, b_dtype, D: int, a_ptr: int, b_ptr: int) -> bool:
    """True when a call with these operands runs the TMA kernel: for a and
    b alike (y is allocated aligned)."""
    return _tma_takes(D, (a_dtype, a_ptr), (b_dtype, b_ptr))


def use_tma_bwd(a_dtype, b_dtype, D: int, *ptrs: int) -> bool:
    """True when a backward call runs the TMA kernel: for a, y and gy (a's
    dtype, at ``ptrs``) and db's rows in b's dtype (da and db are
    allocated aligned)."""
    return _tma_takes(D, *((a_dtype, p) for p in ptrs), (b_dtype, 0))


def lru_scan(a, b, h0=None, *, tma=None):
    """a, b: (B, S, D) contiguous CUDA tensors, each fp32 or bf16; h0:
    (B, D) or None. Returns (y (B, S, D) in a.dtype, h_last (B, D) fp32
    = y[:, -1] widened). ``tma`` forces the kernel (True: the TMA kernel,
    which refuses operands ``use_tma`` would not give it; False: the
    per-thread kernel); None leaves the choice to ``use_tma``."""
    fake = kernels.is_fake(a)
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if (t.device.type != "cuda" and not fake) or t.device != a.device:
            raise ValueError(f"lru_scan kernel: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors on one device (CPU "
                             "tensors go through ops.scan)")
        if not t.is_contiguous():
            raise ValueError(f"lru_scan kernel: {name} must be contiguous")
        if t.dtype not in _DTYPES:
            raise ValueError(f"lru_scan kernel: {name} dtype {t.dtype} "
                             "unsupported (float32, bfloat16)")
    if a.dim() != 3 or b.shape != a.shape or 0 in a.shape:
        raise ValueError(f"lru_scan kernel: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one non-empty (B, S, D)")
    B, S, D = a.shape
    if h0 is not None and h0.shape != (B, D):
        raise ValueError(f"lru_scan kernel: h0 {tuple(h0.shape)} is not "
                         f"(B, D) = {(B, D)}")
    if fake:
        y = torch.empty_like(a)
        h_last = torch.empty((B, D), dtype=torch.float32, device=a.device)
        kernels.notify("lru_scan", (a, b, h0), (y, h_last),
                       flops=2.0 * B * S * D)
        return y, h_last
    global launches, tma_launches
    tma_ok = use_tma(a.dtype, b.dtype, D, a.data_ptr(), b.data_ptr())
    if tma is None:
        tma = tma_ok
    elif tma and not tma_ok:
        raise ValueError(f"lru_scan kernel: the TMA kernel takes 16-byte "
                         f"aligned bases and rows; a {a.dtype}, b {b.dtype}, "
                         f"D={D} refused")
    lib = library()
    y = torch.empty_like(a)
    h_last = torch.empty((B, D), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_lru_scan_fwd(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), B, S, D, _DTYPES[a.dtype],
            _DTYPES[b.dtype], int(tma), stream)
    kernels.raise_on_error(lib, err, "lru_scan kernel")
    launches += 1
    tma_launches += int(tma)
    kernels.notify("lru_scan", (a, b, h0), (y, h_last), flops=2.0 * B * S * D)
    return y, h_last


def lru_scan_bwd(a, h0, y, gy, gh_last, b_dtype, *, tma=None):
    """The gradients of ``lru_scan`` at (a, h0), from its output y, for
    the cotangents gy (of y: a's dtype) and gh_last (of h_last: (B, D));
    a, y, gy contiguous CUDA tensors of one (B, S, D). Returns (da in a's
    dtype, db in ``b_dtype``, dh0 fp32 (B, D), or None where h0 is None).
    ``tma`` forces the kernel, as for the forward (``use_tma_bwd``)."""
    fake = kernels.is_fake(a)
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    gh_last = gh_last.to(torch.float32).contiguous()
    if a.dim() != 3 or 0 in a.shape:
        raise ValueError(f"lru_scan backward kernel: a {tuple(a.shape)} is "
                         "not one non-empty (B, S, D)")
    B, S, D = a.shape
    for name, t, shape in (("a", a, a.shape), ("y", y, a.shape),
                           ("gy", gy, a.shape), ("h0", h0, (B, D)),
                           ("gh_last", gh_last, (B, D))):
        if t is None:
            continue
        if (t.device.type != "cuda" and not fake) or t.device != a.device:
            raise ValueError(f"lru_scan backward kernel: {name} is on "
                             f"{t.device}; the kernel takes CUDA tensors on "
                             "one device (CPU tensors go through ops.scan)")
        if not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"lru_scan backward kernel: {name} "
                             f"{tuple(t.shape)} must be a contiguous "
                             f"{tuple(shape)}")
    if (a.dtype not in _DTYPES or b_dtype not in _DTYPES
            or y.dtype != a.dtype or gy.dtype != a.dtype):
        raise ValueError(f"lru_scan backward kernel: a {a.dtype}, y "
                         f"{y.dtype}, gy {gy.dtype} must share a dtype of "
                         f"float32 or bfloat16 (b {b_dtype})")
    da = torch.empty_like(a)
    db = torch.empty(a.shape, dtype=b_dtype, device=a.device)
    dh0 = (None if h0 is None
           else torch.empty((B, D), dtype=torch.float32, device=a.device))
    if not fake:
        _launch_bwd(a, h0, y, gy, gh_last, da, db, dh0, b_dtype, tma)
    # per element the multiply-add and the da product
    kernels.notify("lru_scan_bwd", (a, h0, y, gy, gh_last),
                   [t for t in (da, db, dh0) if t is not None],
                   flops=3.0 * B * S * D)
    return da, db, dh0


def _launch_bwd(a, h0, y, gy, gh_last, da, db, dh0, b_dtype, tma) -> None:
    global bwd_launches, bwd_tma_launches
    B, S, D = a.shape
    tma_ok = use_tma_bwd(a.dtype, b_dtype, D, a.data_ptr(), y.data_ptr(),
                         gy.data_ptr())
    if tma is None:
        tma = tma_ok
    elif tma and not tma_ok:
        raise ValueError(f"lru_scan backward kernel: the TMA kernel takes "
                         f"16-byte aligned bases and rows; a {a.dtype}, b "
                         f"{b_dtype}, D={D} refused")
    lib = bwd_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_lru_scan_bwd(
            a.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), gy.data_ptr(), gh_last.data_ptr(), da.data_ptr(),
            db.data_ptr(), None if dh0 is None else dh0.data_ptr(), B, S, D,
            _DTYPES[a.dtype], _DTYPES[b_dtype], int(tma), stream)
    kernels.raise_on_error(lib, err, "lru_scan backward kernel")
    bwd_launches += 1
    bwd_tma_launches += int(tma)
