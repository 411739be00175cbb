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

``launches`` counts the kernel's launches in this process, and
``tma_launches`` those of them that took the TMA kernel; callers that want
to show a path went through the kernel set both to 0 and read them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import kernels

SOURCE = Path(__file__).parent / "csrc" / "lru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0
tma_launches = 0


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


def use_tma(a_dtype, b_dtype, D: int, a_ptr: int, b_ptr: int) -> bool:
    """True when a call with these operands runs the TMA kernel: TMA takes
    a base and a row stride (D * element size) that are multiples of 16
    bytes, for a and b alike (y is allocated aligned)."""
    return all(dt in _DTYPES and (D * dt.itemsize) % 16 == 0 and ptr % 16 == 0
               for dt, ptr in ((a_dtype, a_ptr), (b_dtype, b_ptr)))


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
    if err:
        raise RuntimeError("lru_scan kernel launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()} "
                           f"(code {err})")
    launches += 1
    tma_launches += int(tma)
    kernels.notify("lru_scan", (a, b, h0), (y, h_last), flops=2.0 * B * S * D)
    return y, h_last
