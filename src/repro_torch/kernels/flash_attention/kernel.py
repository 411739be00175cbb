"""ctypes binding of the hand-written flash attention kernel.

Counterpart of ``repro/kernels/flash_attention/kernel.py::flash_attention``
(the Pallas TPU kernel). The CUDA C++ source is
``csrc/flash_attention.cu`` (with ``csrc/wgmma.cuh``); it is built by
``nvcc`` for ``sm_90a`` at first use (``repro_torch.kernels.load``). The
C entry point picks the kernel by dtype: bf16 goes to the tensor-core
kernel (``wgmma``, TMA), fp32 to the CUDA-core one. Both read the model's
own layout, strided, and take any sequence length, so nothing is padded,
transposed or copied here. This wrapper checks what the kernel takes,
allocates the output, launches on PyTorch's current stream and raises if
the launch is refused. It takes CUDA tensors only: the CPU goes through
``ref.py`` (see ``ops.attend``). A ``FakeTensor`` (the dry run) is
checked the same way and gets its output allocated, with no launch.

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
# 120 and 160 run at the padded widths 128 and 192 inside the kernel
BF16_HEAD_DIMS = (16, 32, 64, 120, 128, 160, 256)

launches = 0


def library() -> ctypes.CDLL:
    lib = kernels.load("flash_attention", SOURCE)
    fn = lib.repro_flash_attention_fwd
    # (q, k, v, o, strides[12], B, H, KV, Sq, Sk, Dh, causal, window, cap,
    #  scale, kv_len, dtype, stream)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0, kv_len=None) -> torch.Tensor:
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh): CUDA tensors of one dtype
    (fp32 with Dh <= 256, or bf16 with Dh in ``BF16_HEAD_DIMS``), the head
    dimension contiguous, other strides free (bf16: 16-byte aligned, as
    TMA needs). Returns a contiguous (B, Sq, H, Dh) in that dtype."""
    fake = kernels.is_fake(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.device.type != "cuda" and not fake):
            raise ValueError(f"flash_attention kernel: {name} is on "
                             f"{t.device}; the kernel takes CUDA tensors "
                             "(CPU tensors go through ops.attend)")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"flash_attention kernel: {name} must be 4-D "
                             "with a contiguous head dimension, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention kernel: q, k, v must share "
                             "dtype and device")
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} "
                         "unsupported (float32, bfloat16)")
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != Dh or v.shape != k.shape
            or H % KV or not 0 < Dh <= 256):
        raise ValueError(f"flash_attention kernel: shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} rejected "
                         "(GQA needs H % KV == 0; Dh <= 256)")
    if q.dtype == torch.bfloat16:
        if Dh not in BF16_HEAD_DIMS:
            raise ValueError(f"flash_attention kernel: bf16 head dim {Dh} "
                             f"not in {BF16_HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if (not fake and t.data_ptr() % 16) or any(
                    s * 2 % 16 for s in t.stride()[:3]):
                raise ValueError(f"flash_attention kernel: bf16 {name} needs "
                                 "a 16-byte aligned base and strides (TMA), "
                                 f"got strides {t.stride()}")
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    if not fake:
        _launch(q, k, v, o, causal, window, cap, kv_len)
    kernels.notify("flash_attention", (q, k, v), (o,),
                   flops=4.0 * B * H * Sq * Sk * Dh,
                   transcendentals=B * H * Sq * Sk)
    return o


def _launch(q, k, v, o, causal, window, cap, kv_len) -> None:
    global launches
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = library()
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, o) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), B, H, KV, Sq, Sk, Dh,
            int(causal), int(window), float(cap), float(Dh ** -0.5),
            -1 if kv_len is None else int(kv_len), _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError("flash_attention kernel launch failed: "
                           f"{lib.repro_cuda_error_string(err).decode()} "
                           f"(cudaError_t {err})")
    launches += 1
