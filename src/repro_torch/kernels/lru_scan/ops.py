"""Public wrapper for the LRU scan kernel.

Counterpart of ``repro/kernels/lru_scan/ops.py::scan``: routes a CUDA
tensor through the hand-written kernel (or, only when the caller asks
with ``use_kernel=False``, the plain version) and a CPU tensor through
the plain version. Any S and D: the TPU kernel's chunk and block
divisibility does not carry over.

Gradients: the kernel runs inside ``LruScan``, an ``autograd.Function``
whose backward is the hand-written backward kernel
(``kernel.lru_scan_bwd``, through ``LruScanBwd``) on the residuals (a,
h0, y): y is the state trajectory. It computes the reference's analytic
backward (``repro/kernels/lru_scan/ops.py:36-55``) in one pass over
reversed time: lam_t = c_t + a_{t+1} lam_{t+1} (c the cotangent of y,
with that of h_last folded into the last step), da = lam h_{t-1}, db =
lam (in b's dtype), dh0 = a_0 lam_0. Its plain version,
``ref.lru_scan_bwd_ref``, is held against the reference's ``jax.vjp`` in
the tests. The plain route's backward is autograd of ``lru_scan_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (is_dtensor, per_shard, split_axes,
                                 use_kernel_for, vmap_by_folding)
from repro_torch.kernels.lru_scan import kernel
from repro_torch.kernels.lru_scan.ref import lru_scan_ref


class LruScan(torch.autograd.Function):
    """The kernel's forward; backward = the backward kernel (``LruScanBwd``)
    on the saved residuals."""

    @staticmethod
    def forward(a, b, h0):
        return kernel.lru_scan(a.contiguous(), b.contiguous(),
                               None if h0 is None else h0.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, b, h0 = inputs
        y, _ = output
        ctx.save_for_backward(a, h0, y)
        ctx.b_dtype = b.dtype

    @staticmethod
    def backward(ctx, gy, gh_last):
        if gy is None or gh_last is None:
            raise RuntimeError("lru_scan backward: a cotangent is missing")
        a, h0, y = ctx.saved_tensors
        da, db, *dh0 = LruScanBwd.apply(a, h0, y, gy.to(a.dtype),
                                        gh_last, ctx.b_dtype)
        return da, db, dh0[0].to(h0.dtype) if dh0 else None

    @staticmethod
    def vmap(info, in_dims, a, b, h0):
        return vmap_by_folding(LruScan.apply, info, in_dims, (a, b, h0),
                               (True, True, True))


class LruScanBwd(torch.autograd.Function):
    """The backward kernel as a ``Function`` of its own, so that ``vmap``
    of a gradient folds it into one launch; it has no derivative of its
    own. Returns (da, db), and dh0 after them where h0 is given."""

    @staticmethod
    def forward(a, h0, y, gy, gh_last, b_dtype):
        da, db, dh0 = kernel.lru_scan_bwd(a.contiguous(), h0, y.contiguous(),
                                          gy.contiguous(), gh_last, b_dtype)
        return (da, db) if dh0 is None else (da, db, dh0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("lru_scan: the backward kernel has no derivative "
                           "(no double backward)")

    @staticmethod
    def vmap(info, in_dims, *args):
        return vmap_by_folding(LruScanBwd.apply, info, in_dims, args,
                               (True, True, True, True, True, False))


def scan(a, b, h0=None, *, use_kernel: bool = True):
    """a, b: (B, S, D); h0: (B, D) or None -> (y (B, S, D) in a.dtype,
    h_last (B, D) fp32). A ``DTensor`` runs per shard: batch on the
    data axes, channels on ``model``."""
    if is_dtensor(a):
        from repro_torch.sharding.rules import P
        bt, m = split_axes(a, a.shape[0], a.shape[2])
        seq, row = P(bt, None, m), P(bt, m)
        return per_shard(lambda *x: scan(*x, use_kernel=use_kernel),
                         (a, b, h0), (seq, seq, row), (seq, row))
    if use_kernel_for(a, use_kernel):
        return LruScan.apply(a, b, h0)
    return lru_scan_ref(a, b, h0)
