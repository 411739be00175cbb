"""Public wrapper for the WKV6 kernel.

Counterpart of ``repro/kernels/wkv6/ops.py::mix``: routes a CUDA tensor
through the hand-written kernel (or, only when the caller asks with
``use_kernel=False``, the plain version) and a CPU tensor through the
plain version. Any T, T = 1 (a decode step) included: the TPU kernel's
chunk divisibility does not carry over.

Gradients: the kernel runs inside ``Wkv6``, an ``autograd.Function``
whose backward is the hand-written backward kernel
(``kernel.wkv6_bwd``) on the saved inputs. The reference's
``custom_vjp`` differentiates its oracle
(``repro/kernels/wkv6/ops.py:31-36``); the backward kernel computes the
same gradients (its plain versions, ``ref.wkv6_chunked_bwd_ref`` and
``ref.wkv6_recurrent_bwd_ref``, one a route, are held against the
reference's ``jax.grad`` in the tests). The plain route's
backward stays ``ref.wkv6_ref_vjp``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (is_dtensor, per_shard, split_axes,
                                 use_kernel_for, vmap_by_folding)
from repro_torch.kernels.wkv6 import kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref


class Wkv6(torch.autograd.Function):
    """The kernel's forward; backward = the backward kernel (``Wkv6Bwd``)
    on the saved inputs."""

    @staticmethod
    def forward(r, k, v, w, u, s0):
        return kernel.wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                           w, u, s0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.has_s0 = inputs[5] is not None
        ctx.dtypes = (inputs[3].dtype, inputs[4].dtype)
        ctx.save_for_backward(*(t.contiguous() for t in inputs
                                if t is not None))

    @staticmethod
    def backward(ctx, go, gs):
        if go is None or gs is None:
            raise RuntimeError("wkv6 backward: a cotangent is missing")
        r, k, v, w, u, *s0 = ctx.saved_tensors
        s0 = s0[0] if ctx.has_s0 else None
        dr, dk, dv, dw, du_rows, ds0 = Wkv6Bwd.apply(
            r, k, v, w, u, s0, go.to(r.dtype).contiguous(),
            gs.float().contiguous())
        return (dr, dk, dv, dw.to(ctx.dtypes[0]),
                du_rows.sum(0).to(ctx.dtypes[1]),
                None if s0 is None else ds0.to(s0.dtype))

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u, s0):
        return vmap_by_folding(Wkv6.apply, info, in_dims,
                               (r, k, v, w, u, s0),
                               (True, True, True, True, False, True))


class Wkv6Bwd(torch.autograd.Function):
    """The backward kernel as a ``Function`` of its own, so that ``vmap``
    of a gradient folds it into one launch (du comes by batch row for
    that); it has no derivative of its own."""

    @staticmethod
    def forward(r, k, v, w, u, s0, go, gs):
        return kernel.wkv6_bwd(r, k, v, w, u, s0, go, gs)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("wkv6: the backward kernel has no derivative (no "
                           "double backward)")

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_by_folding(Wkv6Bwd.apply, info, in_dims, args,
                               (True, True, True, True, False, True, True,
                                True))


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
