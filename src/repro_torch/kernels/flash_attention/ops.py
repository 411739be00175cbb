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
``autograd.Function``. When a gradient may be asked for (grad mode on
and an input that requires it; serving runs under ``inference_mode``)
the forward also writes each row's log-sum-exp, and the backward is the
hand-written backward kernel (``kernel.flash_attention_bwd``) on the
saved (q, k, v, o, lse), in the model's layout, unpadded. The reference's
``custom_vjp`` differentiates its oracle
(``repro/kernels/flash_attention/ops.py:41-48``); the backward kernel
computes the same gradients (its plain version,
``ref.flash_attention_bwd_ref``, is held against the reference's
``jax.grad`` in the tests).
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
    """The kernel's forward, with each row's log-sum-exp when a gradient
    may be asked for (``with_lse``); backward = the backward kernel
    (``FlashAttentionBwd``) on the saved (q, k, v, o, lse)."""

    @staticmethod
    def forward(q, k, v, causal, window, cap, bq, bk, with_lse):
        kw = dict(causal=causal, window=window, cap=cap)
        if with_lse:
            return kernel.flash_attention(q, k, v, lse=True, **kw)
        return (kernel.flash_attention(q, k, v, **kw),)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, cap, *_ = inputs
        ctx.opts = (causal, window, cap)
        if len(output) == 2:
            ctx.mark_non_differentiable(output[1])
            ctx.save_for_backward(q, k, v, *output)

    @staticmethod
    def backward(ctx, g, *_):
        if g is None:
            raise RuntimeError("flash_attention backward: no cotangent for "
                               "the output")
        saved = ctx.saved_tensors   # unpacked once (checkpoint allows one)
        if len(saved) != 5:
            raise RuntimeError("flash_attention backward: the forward kept "
                               "no lse (it ran without a gradient to ask "
                               "for)")
        q, k, v, o, lse = saved
        dq, dk, dv = FlashAttentionBwd.apply(q, k, v, o, lse, g.contiguous(),
                                             *ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, cap, bq, bk, with_lse):
        # a gradient transform below the vmap sees its inputs here, not
        # where ``attend`` looked
        with_lse = with_lse or _wants_grad(q, k, v)
        return vmap_by_folding(
            FlashAttention.apply, info, in_dims,
            (q, k, v, causal, window, cap, bq, bk, with_lse),
            (True,) * 3 + (False,) * 6)


class FlashAttentionBwd(torch.autograd.Function):
    """The backward kernel as a ``Function`` of its own, so that ``vmap``
    of a gradient folds it into one launch (its ``vmap`` rule); it has no
    derivative of its own."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, cap):
        return kernel.flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                          window=window, cap=cap)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention: the backward kernel has no "
                           "derivative (no double backward)")

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_by_folding(FlashAttentionBwd.apply, info, in_dims, args,
                               (True,) * 6 + (False,) * 3)


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


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
        return FlashAttention.apply(q, k, v, causal, window, cap, bq, bk,
                                    _wants_grad(q, k, v))[0]
    return attend_plain(q, k, v, causal, window, cap, bq, bk)
