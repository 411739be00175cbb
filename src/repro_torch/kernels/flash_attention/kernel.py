"""ctypes binding of the hand-written flash attention kernel.

Counterpart of ``repro/kernels/flash_attention/kernel.py::flash_attention``
(the Pallas TPU kernel). The CUDA C++ source is
``csrc/flash_attention.cu``; it is built by ``nvcc`` for ``sm_90a`` at
first use (``repro_torch.kernels.load``). This wrapper checks what the
kernel takes, allocates the output, launches on PyTorch's current stream
and raises if the launch is refused. It takes CUDA tensors only: the CPU
goes through ``ref.py`` (see ``ops.attend``).

``launches`` counts the kernel's launches in this process; callers that
want to show a path went through the kernel set it to 0 and read it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import kernels

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def library() -> ctypes.CDLL:
    lib = kernels.load("flash_attention", SOURCE)
    fn = lib.repro_flash_attention_fwd
    # (q, k, v, o, B, H, KV, Sq, Sk, Dh, causal, window, cap, scale,
    #  kv_len, dtype, stream)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0, kv_len=None) -> torch.Tensor:
    """q: (B, H, Sq, Dh); k, v: (B, KV, Sk, Dh), contiguous CUDA tensors
    of one dtype (fp32 or bf16). Returns (B, H, Sq, Dh) in that dtype."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}; the kernel takes CUDA tensors "
                             "(CPU tensors go through ops.attend)")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention kernel: {name} must be a "
                             f"contiguous 4-D tensor, got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention kernel: q, k, v must share "
                             "dtype and device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} "
                         "unsupported (float32, bfloat16)")
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != Dh or v.shape != k.shape
            or H % KV or not 0 < Dh <= 256):
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} rejected "
                         "(GQA needs H % KV == 0; Dh <= 256)")
    lib = library()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, KV, Sq, Sk, Dh, int(causal), int(window), float(cap),
            float(Dh ** -0.5), -1 if kv_len is None else int(kv_len),
            _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()} "
                           f"(cudaError_t {err})")
    launches += 1
    return o
