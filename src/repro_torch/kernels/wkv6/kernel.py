"""ctypes binding of the hand-written WKV6 kernel.

Counterpart of ``repro/kernels/wkv6/kernel.py::wkv6`` (the Pallas TPU
kernel). The CUDA C++ source is ``csrc/wkv6.cu``, built by ``nvcc`` for
``sm_90a`` at first use (``repro_torch.kernels.load``). Its entry point
launches one of two kernels per call, the one ``chunked`` picks: the
chunked form on the tensor cores (prefill), or the recurrent one (a
decode step, T = 1). This wrapper checks what the kernel
takes, allocates the outputs, launches on PyTorch's current stream and
raises if the launch is refused. It takes CUDA tensors only: the CPU goes
through ``ref.py`` (see ``ops.mix``).

A ``FakeTensor`` (the dry run) is checked the same way and gets its
outputs allocated, with no launch.

The backward, ``wkv6_bwd``, is a second library from ``csrc/wkv6_bwd.cu``,
bound the same way; ``chunked`` picks its route too. The chunked route
runs both state passes in one launch, then one block per chunk computes
every gradient in the chunk form: dr, dk and dv as products on the tensor
cores, dw from those products and the pairs inside each sub-chunk; the
recurrent route (T < 32, N = 8) runs the state passes step by step and
every gradient by the step recurrence. Each route's plain version is in
``ref.py`` (``wkv6_bwd_plain`` picks by the same rule).

``launches`` and ``bwd_launches`` count the forward's and the backward's
launches in this process; callers that want to show a path went through
the kernels set them to 0 and read them.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch import kernels

SOURCE = Path(__file__).parent / "csrc" / "wkv6.cu"
BWD_SOURCE = Path(__file__).parent / "csrc" / "wkv6_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (8, 16, 32, 64)
# steps per chunk and per sub-chunk of the chunked kernel (csrc/wkv6.cu,
# kChunk and kSub; ``library`` checks them)
CHUNK, SUB = 32, 8

launches = 0
bwd_launches = 0


@functools.cache
def library() -> ctypes.CDLL:
    lib = kernels.load("wkv6", SOURCE)
    fn = lib.repro_wkv6_fwd
    # (r, k, v, w, u, s0 or NULL, o, s_T, B, T, H, N, dtype, chunked, stream)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    chunk, sub = ctypes.c_int(), ctypes.c_int()
    lib.repro_wkv6_chunk_shape(ctypes.byref(chunk), ctypes.byref(sub))
    if (chunk.value, sub.value) != (CHUNK, SUB):
        raise RuntimeError(f"wkv6 kernel: chunk {chunk.value}, sub-chunk "
                           f"{sub.value} in csrc/wkv6.cu, but {CHUNK}, {SUB} "
                           "here (kernel.CHUNK, SUB)")
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def bwd_library() -> ctypes.CDLL:
    lib = kernels.load("wkv6_bwd", BWD_SOURCE)
    fn = lib.repro_wkv6_bwd
    # (r, k, v, w, u, s0 or NULL, do, ds_T, dr, dk, dv, dw, du, ds0,
    #  states_s, states_g, du_part, B, T, H, N, dtype, chunked, stream)
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def chunked(T: int, N: int) -> bool:
    """True when a call of this T and N runs the chunked kernel."""
    return T >= CHUNK and N >= 16


def wkv6(r, k, v, w, u, s0=None):
    """r, k, v: (B, T, H, N) contiguous CUDA tensors of one dtype (fp32 or
    bf16); w: (B, T, H, N), u: (H, N), s0: (B, H, N, N) or None, taken in
    fp32. N in ``HEAD_SIZES``. Returns (o (B, T, H, N) in r.dtype, s_T
    (B, H, N, N) fp32)."""
    w, u, s0 = _fp32(w, u, s0)
    _check(r, k, v, w, u, s0)
    B, T, H, N = r.shape
    o = torch.empty_like(r)
    s_T = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    if not kernels.is_fake(r):
        _launch(r, k, v, w, u, s0, o, s_T)
    # per (b, t, h): k^T v, u (.) kv, S + that, r @ it, w (.) S + kv
    kernels.notify("wkv6", (r, k, v, w, u, s0), (o, s_T),
                   flops=7.0 * B * T * H * N * N)
    return o, s_T


def _fp32(*ts):
    return tuple(None if t is None else t.to(torch.float32).contiguous()
                 for t in ts)


def _check(r, k, v, w, u, s0, *more) -> None:
    """What both kernels take; ``more`` are further (name, tensor, (shape,
    dtype)) triples (the backward's cotangents), contiguous on r's
    device."""
    fake = kernels.is_fake(r)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u),
                    ("s0", s0), *((n, t) for n, t, _ in more)):
        if t is None:
            continue
        if (t.device.type != "cuda" and not fake) or t.device != r.device:
            raise ValueError(f"wkv6 kernel: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors on one device (CPU "
                             "tensors go through ops.mix)")
        if not t.is_contiguous() or (not fake and t.data_ptr() % 16):
            raise ValueError(f"wkv6 kernel: {name} must be contiguous and "
                             "16-byte aligned (cp.async)")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"wkv6 kernel: r, k, v must share one dtype of "
                         f"float32, bfloat16; got {r.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if r.dim() != 4 or 0 in r.shape:
        raise ValueError(f"wkv6 kernel: r {tuple(r.shape)} is not a "
                         "non-empty (B, T, H, N)")
    B, T, H, N = r.shape
    if (k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or u.shape != (H, N)
            or (s0 is not None and s0.shape != (B, H, N, N))):
        raise ValueError(f"wkv6 kernel: shapes r {tuple(r.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} w "
                         f"{tuple(w.shape)} u {tuple(u.shape)} s0 "
                         f"{None if s0 is None else tuple(s0.shape)} rejected")
    if N not in HEAD_SIZES:
        raise ValueError(f"wkv6 kernel: head size {N} not in {HEAD_SIZES}")
    for name, t, (shape, dtype) in more:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"wkv6 backward: {name} {t.dtype} "
                             f"{tuple(t.shape)}, expected {dtype} {shape}")


def wkv6_bwd(r, k, v, w, u, s0, do, ds_T):
    """The gradients of ``wkv6`` at (r, k, v, w, u, s0) for the cotangents
    do (of o: (B, T, H, N), r's dtype) and ds_T (of s_T: (B, H, N, N)
    fp32), contiguous CUDA tensors as the forward takes them. Returns (dr,
    dk, dv in r's dtype; dw fp32 (B, T, H, N); du by batch row, fp32 (B, H,
    N), which the caller sums over the rows; ds0 fp32 (B, H, N, N), the
    gradient of the initial state, zeros or s0). Deterministic: no
    atomics."""
    w, u, s0, ds_T = _fp32(w, u, s0, ds_T)
    B, T, H, N = r.shape
    _check(r, k, v, w, u, s0, ("do", do, (r.shape, r.dtype)),
           ("ds_T", ds_T, ((B, H, N, N), torch.float32)))
    nc = -(-T // CHUNK)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dw = torch.empty_like(w)
    f32 = dict(dtype=torch.float32, device=r.device)
    du_rows = torch.empty((B, H, N), **f32)
    ds0 = torch.empty((B, H, N, N), **f32)
    # scratch: each chunk's incoming state and state gradient, du by chunk
    states_s, states_g = (torch.empty((B, nc, H, N, N), **f32)
                          for _ in range(2))
    du_part = torch.empty((B, nc, H, N), **f32)
    outs = (dr, dk, dv, dw, du_rows, ds0)
    if not kernels.is_fake(r):
        _launch_bwd(r, k, v, w, u, s0, do, ds_T, *outs, states_s, states_g,
                    du_part)
    # per (b, t, h), the recurrent route's work, which bounds the chunked
    # route's from above: the two state passes' products (2 N^2 each) and
    # the recurrence per state element: S twice (checkpoints and history),
    # G, and the four sums into dk, dw, dr, dv
    kernels.notify("wkv6_bwd", (r, k, v, w, u, s0, do, ds_T), outs,
                   flops=17.0 * B * T * H * N * N)
    return outs


def _launch(r, k, v, w, u, s0, o, s_T) -> None:
    global launches
    B, T, H, N = r.shape
    lib = library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_wkv6_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            o.data_ptr(), s_T.data_ptr(), B, T, H, N, _DTYPES[r.dtype],
            int(chunked(T, N)), stream)
    kernels.raise_on_error(lib, err, "wkv6 kernel")
    launches += 1


def _launch_bwd(r, k, v, w, u, s0, do, ds_T, *bufs) -> None:
    global bwd_launches
    B, T, H, N = r.shape
    lib = bwd_library()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.repro_wkv6_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            do.data_ptr(), ds_T.data_ptr(), *(t.data_ptr() for t in bufs),
            B, T, H, N, _DTYPES[r.dtype], int(chunked(T, N)), stream)
    kernels.raise_on_error(lib, err, "wkv6 backward kernel")
    bwd_launches += 1
