"""Public wrapper for the WKV6 kernel.

Counterpart of ``repro/kernels/wkv6/ops.py::mix``: routes a CUDA tensor
through the hand-written kernel (or, only when the caller asks with
``use_kernel=False``, the plain version) and a CPU tensor through the
plain version. Any T, T = 1 (a decode step) included: the TPU kernel's
chunk divisibility does not carry over.

Gradients: the kernel runs inside ``Wkv6``, an ``autograd.Function``
whose backward is the VJP of the chunk-checkpointed plain version
(``wkv6_ref`` with ``chunk=128``: ``ref.wkv6_ref_vjp``, the plain
route's own backward) on the saved inputs, as the reference's
``custom_vjp`` differentiates its oracle
(``repro/kernels/wkv6/ops.py:31-36``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (is_dtensor, per_shard, split_axes,
                                 use_kernel_for, vmap_by_folding)
from repro_torch.kernels.wkv6 import kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref, wkv6_ref_vjp

BWD_CHUNK = 128


class Wkv6(torch.autograd.Function):
    """The kernel's forward; backward = VJP of the chunked plain version."""

    @staticmethod
    def forward(r, k, v, w, u, s0):
        return kernel.wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                           w, u, s0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.has_s0 = inputs[5] is not None
        ctx.save_for_backward(*(t.contiguous() for t in inputs
                                if t is not None))

    @staticmethod
    def backward(ctx, go, gs):
        saved = list(ctx.saved_tensors)
        if not ctx.has_s0:
            saved.append(None)
        return wkv6_ref_vjp((go, gs), *saved, chunk=BWD_CHUNK)

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, s0):
        return vmap_by_folding(Wkv6.apply, info, in_dims,
                               (r, k, v, w, u, s0),
                               (True, True, True, True, False, True))


def mix(r, k, v, w, u, s0=None, *, use_kernel: bool = True):
    """r, k, v, w: (B, T, H, N); u: (H, N); s0: (B, H, N, N) or None ->
    (o (B, T, H, N) in r.dtype, s_T (B, H, N, N) fp32). A ``DTensor``
    runs per shard: batch on the data axes, heads on ``model``."""
    if is_dtensor(r):
        from repro_torch.sharding.rules import P
        b, m = split_axes(r, r.shape[0], r.shape[2])
        seq, state = P(b, None, m), P(b, m)
        return per_shard(
            lambda *a: mix(*a, use_kernel=use_kernel),
            (r, k, v, w, u, s0), (seq, seq, seq, seq, P(m), state),
            (seq, state))
    if use_kernel_for(r, use_kernel):
        return Wkv6.apply(r, k, v, w, u, s0)
    return wkv6_ref(r, k, v, w, u, s0)
