"""ctypes binding of the hand-written LRU scan kernel.

Counterpart of ``repro/kernels/lru_scan/kernel.py::lru_scan`` (the Pallas
TPU kernel). The CUDA C++ source is ``csrc/lru_scan.cu``, built by
``nvcc`` for ``sm_90a`` at first use (``repro_torch.kernels.load``). This
wrapper checks what the kernel takes, allocates the outputs, launches on
PyTorch's current stream and raises if the launch is refused. It takes
CUDA tensors only: the CPU goes through ``ref.py`` (see ``ops.scan``).

``launches`` counts the kernel's launches in this process; callers that
want to show a path went through the kernel set it to 0 and read it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import kernels

SOURCE = Path(__file__).parent / "csrc" / "lru_scan.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def library() -> ctypes.CDLL:
    lib = kernels.load("lru_scan", SOURCE)
    fn = lib.repro_lru_scan_fwd
    # (a, b, h0 or NULL, y, h_last, B, S, D, a_dtype, b_dtype, stream)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def lru_scan(a, b, h0=None):
    """a, b: (B, S, D) contiguous CUDA tensors, each fp32 or bf16; h0:
    (B, D) or None. Returns (y (B, S, D) in a.dtype, h_last (B, D) fp32
    = y[:, -1] widened)."""
    global launches
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != a.device:
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
    lib = library()
    y = torch.empty_like(a)
    h_last = torch.empty((B, D), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.repro_lru_scan_fwd(
            a.data_ptr(), b.data_ptr(), None if h0 is None else h0.data_ptr(),
            y.data_ptr(), h_last.data_ptr(), B, S, D, _DTYPES[a.dtype],
            _DTYPES[b.dtype], stream)
    if err:
        raise RuntimeError("lru_scan kernel launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()} "
                           f"(cudaError_t {err})")
    launches += 1
    return y, h_last
