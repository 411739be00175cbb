"""Public wrapper for the flash attention kernel.

Counterpart of ``repro/kernels/flash_attention/ops.py::attend``: accepts
the model's (B, S, H, Dh) layout and routes. A CUDA tensor goes straight
to the hand-written kernel, which reads that layout and masks the ragged
last tile itself: no transpose, pad or copy, and the output is the
model's layout. A CPU tensor (or a CUDA one with ``use_kernel=False``)
takes the plain version the reference's way (``attend_plain``):
transposed to (B, H, S, Dh) and padded to a block multiple, with
``kv_len`` set only when padding happened. Padding changes no real row:
padded keys are masked by ``kv_len`` and padded query rows are sliced
away, so both routes compute one function.

Gradients: the kernel runs inside ``FlashAttention``, an
``autograd.Function`` whose backward is the VJP of ``attend_plain`` on
the saved (q, k, v), as the reference's ``custom_vjp`` differentiates
its oracle (``repro/kernels/flash_attention/ops.py:41-48``): both routes
differentiate one function, in one layout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import (is_dtensor, per_shard, split_axes,
                                 use_kernel_for, vmap_by_folding)
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def attend_plain(q, k, v, causal: bool = True, window: int = 0,
                 cap: float = 0.0, bq: int = 128, bk: int = 128):
    """The plain version in the reference's transposed, padded layout."""
    Sq, Sk = q.shape[1], k.shape[1]
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    bq_ = min(bq, Sq)
    bk_ = min(bk, Sk)
    pq = (-Sq) % bq_
    pk = (-Sk) % bk_
    kv_len = Sk if pk else None
    if pq:
        qt = F.pad(qt, (0, 0, 0, pq))
    if pk:
        kt = F.pad(kt, (0, 0, 0, pk))
        vt = F.pad(vt, (0, 0, 0, pk))
    ot = flash_attention_ref(qt, kt, vt, causal=causal, window=window,
                             cap=cap, kv_len=kv_len)
    return ot[:, :, :Sq].transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """The kernel's forward; backward = VJP of ``attend_plain``."""

    @staticmethod
    def forward(q, k, v, causal, window, cap, bq, bk):
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      cap=cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, *opts = inputs
        ctx.save_for_backward(q.contiguous(), k.contiguous(), v.contiguous())
        ctx.opts = opts

    @staticmethod
    def backward(ctx, g):
        if g is None:
            raise RuntimeError("flash_attention backward: no cotangent for "
                               "the output")
        q, k, v = ctx.saved_tensors
        _, vjp = torch.func.vjp(
            lambda q_, k_, v_: attend_plain(q_, k_, v_, *ctx.opts), q, k, v)
        return (*vjp(g.contiguous()), None, None, None, None, None)

    @staticmethod
    def vmap(info, in_dims, q, k, v, *opts):
        out, dims = vmap_by_folding(
            lambda *a: (FlashAttention.apply(*a),), info, in_dims,
            (q, k, v, *opts), (True, True, True) + (False,) * len(opts))
        return out[0], dims[0]


def attend(q, k, v, *, causal: bool = True, window: int = 0,
           cap: float = 0.0, bq: int = 128, bk: int = 128,
           use_kernel: bool = True):
    """q: (B, S, H, Dh); k, v: (B, S, KV, Dh) -> (B, S, H, Dh). A
    ``DTensor`` runs per shard: batch on the data axes, whole heads on
    ``model`` when it divides H and KV, else every head on each rank."""
    if is_dtensor(q):
        from repro_torch.sharding.rules import P
        b, m = split_axes(q, q.shape[0], q.shape[2], k.shape[2])
        spec = P(b, None, m)
        return per_shard(
            lambda q_, k_, v_: attend(q_, k_, v_, causal=causal,
                                      window=window, cap=cap, bq=bq, bk=bk,
                                      use_kernel=use_kernel),
            (q, k, v), (spec,) * 3, (spec,))
    if use_kernel_for(q, use_kernel):
        return FlashAttention.apply(q, k, v, causal, window, cap, bq, bk)
    return attend_plain(q, k, v, causal, window, cap, bq, bk)
