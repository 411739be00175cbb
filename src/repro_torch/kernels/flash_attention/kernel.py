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

The backward, ``flash_attention_bwd``, is a second library from
``csrc/flash_attention_bwd.cu``, bound the same way: in bf16 one
warp-specialised kernel computes dK, dV and dQ from the forward's
``lse`` (S and dP once per tile pair), between a pass that writes each
row's (lse, D) and one that casts dQ's fp32 workspace; in fp32 the
CUDA-core kernels of FA2's split. The wrapper allocates their scratch
(``bwd_scratch``).

``launches`` and ``bwd_launches`` count the forward's and the backward's
launches in this process; callers that want to show a path went through
the kernels set them to 0 and read them.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import kernels

SOURCE = Path(__file__).parent / "csrc" / "flash_attention.cu"
BWD_SOURCE = Path(__file__).parent / "csrc" / "flash_attention_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# 120 and 160 run at the padded widths 128 and 192 inside the kernel
BF16_HEAD_DIMS = (16, 32, 64, 120, 128, 160, 256)

launches = 0
bwd_launches = 0


def library() -> ctypes.CDLL:
    lib = kernels.load("flash_attention", SOURCE)
    fn = lib.repro_flash_attention_fwd
    # (q, k, v, o, strides[12], B, H, KV, Sq, Sk, Dh, causal, window, cap,
    #  scale, kv_len, dtype, stream, lse or NULL)
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bwd_library() -> ctypes.CDLL:
    lib = kernels.load("flash_attention_bwd", BWD_SOURCE)
    fn = lib.repro_flash_attention_bwd
    # (q, k, v, o, dout, lse, dq, dk, dv, rows, dq_acc, sems, kv_acc (the
    #  last three NULL in fp32, kv_acc also where H == KV), strides[24], B,
    #  H, KV, Sq, Sk, Dh, causal, window, cap, scale, kv_len, slabs, dtype,
    #  stream)
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.repro_flash_bwd_tiles.argtypes = [ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 3
    lib.repro_flash_bwd_tiles.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    for Dh in BF16_HEAD_DIMS:
        got = [ctypes.c_int() for _ in range(3)]
        err = lib.repro_flash_bwd_tiles(Dh, *got)
        if err or tuple(x.value for x in got) != bwd_tiles(Dh):
            raise RuntimeError(
                f"flash_attention backward library tiles Dh {Dh} as "
                f"{tuple(x.value for x in got)} (code {err}); the binding "
                f"sizes its scratch for {bwd_tiles(Dh)}")
    return lib


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0, kv_len=None, lse: bool = False):
    """q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh): CUDA tensors of one dtype
    (fp32 with Dh <= 256, or bf16 with Dh in ``BF16_HEAD_DIMS``), the head
    dimension contiguous, other strides free (bf16: 16-byte aligned, as
    TMA needs). Returns a contiguous (B, Sq, H, Dh) in that dtype; with
    ``lse`` also each row's log-sum-exp of the scaled, capped, masked
    scores, fp32 (B, H, Sq), which the backward takes."""
    _check(q, k, v)
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse_t = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
             if lse else None)
    if not kernels.is_fake(q):
        _launch(q, k, v, o, lse_t, causal, window, cap, kv_len)
    kernels.notify("flash_attention", (q, k, v), (o,) if lse_t is None
                   else (o, lse_t),
                   flops=4.0 * B * H * Sq * Sk * Dh,
                   transcendentals=B * H * Sq * Sk)
    return o if lse_t is None else (o, lse_t)


def _check(q, k, v, *more) -> None:
    """What both kernels take: ``more`` are further (name, tensor) pairs
    laid out as q (o, the output's cotangent)."""
    fake = kernels.is_fake(q)
    for name, t in (("q", q), ("k", k), ("v", v), *more):
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
        for name, t in (("q", q), ("k", k), ("v", v), *more):
            if (not fake and t.data_ptr() % 16) or any(
                    s * 2 % 16 for s in t.stride()[:3]):
                raise ValueError(f"flash_attention kernel: bf16 {name} needs "
                                 "a 16-byte aligned base and strides (TMA), "
                                 f"got strides {t.stride()}")
    for name, t in more:
        if t.shape != q.shape:
            raise ValueError(f"flash_attention kernel: {name} "
                             f"{tuple(t.shape)} must have q's shape "
                             f"{tuple(q.shape)}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, cap: float = 0.0, kv_len=None):
    """The gradients (dq, dk, dv) of ``flash_attention`` for the output
    cotangent ``do``, from the forward's output ``o`` and ``lse``: q, o, do
    (B, Sq, H, Dh), k, v (B, Sk, KV, Dh) as the forward takes them (o and
    do strided as q may be), lse fp32 (B, H, Sq) contiguous. Returns
    contiguous gradients in the inputs' dtype. Deterministic: no
    floating-point atomics, every sum in one fixed order."""
    _check(q, k, v, ("o", o), ("do", do))
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    if (lse.dtype != torch.float32 or lse.shape != (B, H, Sq)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError("flash_attention backward: lse must be a contiguous "
                         f"fp32 (B, H, Sq) = {(B, H, Sq)} on q's device, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    slabs = bwd_slabs(Sk, Dh, causal, window)
    scratch = bwd_scratch(q, k, slabs)
    if not kernels.is_fake(q):
        _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, scratch, slabs, causal,
                    window, cap, kv_len)
    # S = q k^T again, dP = do v^T, dV, dQ, dK over the full tile grid
    kernels.notify("flash_attention_bwd", (q, k, v, o, lse, do),
                   (dq, dk, dv), flops=10.0 * B * H * Sq * Sk * Dh,
                   transcendentals=B * H * Sq * Sk)
    return dq, dk, dv


def bwd_tiles(Dh: int) -> tuple:
    """The bf16 backward kernel's tiling for head dim ``Dh``
    (csrc/flash_attention_bwd.cu; ``bwd_library`` checks it against
    ``repro_flash_bwd_tiles``): (keys a block, queries a tile, the padded
    width). Up to width 128 a block takes 128 keys, 64 to each of its two
    consumers; at 192 and 256 it takes 64, its consumers splitting the
    columns."""
    width = Dh if Dh < 64 else -(-Dh // 64) * 64
    return (128 if width <= 128 else 64), 64, width


# non-causal shapes: key tiles a dQ slab orders (its chain of ordered adds)
SLAB_KEY_TILES = 4


def bwd_slabs(Sk: int, Dh: int, causal: bool, window: int) -> int:
    """The dQ workspaces the bf16 kernel's key tiles add into (key tile n
    into slab n mod slabs, in key-tile order; the cast pass adds the slabs
    in order). Non-causal shapes without a window spread their key tiles
    over slabs of ``SLAB_KEY_TILES``: every key tile there reaches each
    query tile, and one slab would chain all their adds. The rest of the
    schedule (how a key tile's heads split over blocks) is the kernel's
    own (``choose_target`` in csrc/flash_attention_bwd.cu)."""
    nkt = -(-Sk // bwd_tiles(Dh)[0])
    return 1 if causal or window > 0 else -(-nkt // SLAB_KEY_TILES)


def bwd_scratch(q, k, slabs: int) -> dict:
    """The backward kernels' scratch on q's device (its current stream).
    bf16, with nq query tiles and nkt key tiles (``bwd_tiles``) and
    ``slabs`` dQ workspaces (``bwd_slabs``): ``rows`` fp32 (B, H, nq * 64,
    2), each row's (lse log2(e), D); ``dq_acc`` fp32 (slabs, B, H, nq, 64 *
    width), dQ's sums in the kernel's layout; ``sems`` int32 zeros, one per
    (slab, b, h, query tile), then one per (b, kv head, key tile), the
    order of the adds, then the kernel's fault word; ``kv_acc`` fp32 (B,
    KV, nkt, 2, key tile * width), the head chunks' dK, dV sums, wherever a
    group has more than one head (the kernel may split it over blocks).
    fp32: ``rows`` is D, fp32 (B, H, Sq), and the rest None."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    f32 = dict(dtype=torch.float32, device=q.device)
    if q.dtype != torch.bfloat16:
        return {"rows": torch.empty((B, H, Sq), **f32), "dq_acc": None,
                "sems": None, "kv_acc": None}
    key_tile, q_tile, width = bwd_tiles(Dh)
    nq, nkt = -(-Sq // q_tile), -(-k.shape[1] // key_tile)
    return {"rows": torch.empty((B, H, nq * q_tile, 2), **f32),
            "dq_acc": torch.empty((slabs, B, H, nq, q_tile * width), **f32),
            "sems": torch.zeros(slabs * B * H * nq + B * KV * nkt + 1,
                                dtype=torch.int32, device=q.device),
            "kv_acc": (torch.empty((B, KV, nkt, 2, key_tile * width), **f32)
                       if H > KV else None)}


def _launch_bwd(q, k, v, o, lse, do, dq, dk, dv, scratch, slabs, causal,
                window, cap, kv_len) -> None:
    global bwd_launches
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    lib = bwd_library()
    strides = (ctypes.c_longlong * 24)(
        *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, o, do, lse, dq, dk, dv)),
            *(None if scratch[n] is None else scratch[n].data_ptr()
              for n in ("rows", "dq_acc", "sems", "kv_acc")),
            ctypes.cast(strides, ctypes.c_void_p), B, H, KV, Sq, Sk, Dh,
            int(causal), int(window), float(cap), float(Dh ** -0.5),
            -1 if kv_len is None else int(kv_len), slabs, _DTYPES[q.dtype],
            stream)
    kernels.raise_on_error(lib, err, "flash_attention backward kernel")
    bwd_launches += 1


def _launch(q, k, v, o, lse, causal, window, cap, kv_len) -> None:
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
            -1 if kv_len is None else int(kv_len), _DTYPES[q.dtype], stream,
            None if lse is None else lse.data_ptr())
    kernels.raise_on_error(lib, err, "flash_attention kernel")
    launches += 1
