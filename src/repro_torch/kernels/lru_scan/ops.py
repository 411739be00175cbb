"""Public wrapper for the LRU scan kernel.

Counterpart of ``repro/kernels/lru_scan/ops.py::scan``: routes a CUDA
tensor through the hand-written kernel (or, only when the caller asks
with ``use_kernel=False``, the plain version) and a CPU tensor through
the plain version. Any S and D: the TPU kernel's chunk and block
divisibility does not carry over.

Gradients: the kernel runs inside ``LruScan``, an ``autograd.Function``
with the reference's analytic backward (``repro/kernels/lru_scan/
ops.py:36-55``). For h_t = a_t h_{t-1} + b_t the cotangent recurrence
lam_t = c_t + a_{t+1} lam_{t+1} is itself an LRU scan on reversed time
with coefficients [0, a_{S-1}, ..., a_1], so the backward runs the same
kernel once more (through ``LruScan`` again, so that ``vmap`` of a
gradient folds it too), then elementwise products: da = lam h_{t-1},
db = lam (in b's dtype), dh0 = a_0 lam_0. The residuals are (a, h0, y):
y is the state trajectory.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import use_kernel_for, vmap_by_folding
from repro_torch.kernels.lru_scan import kernel
from repro_torch.kernels.lru_scan.ref import lru_scan_ref


class LruScan(torch.autograd.Function):
    """The kernel's forward; backward = the kernel on reversed time."""

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
        af = a.float()
        c = gy.float()
        # h_last aliases y[:, -1]
        c = torch.cat([c[:, :-1], c[:, -1:] + gh_last.float()[:, None]], 1)
        a_rev = torch.cat([torch.zeros_like(af[:, :1]),
                           af.flip(1)[:, :-1]], 1)
        mu, _ = LruScan.apply(a_rev, c.flip(1), None)
        lam = mu.float().flip(1)
        h_init = (torch.zeros_like(af[:, 0]) if h0 is None else h0.float())
        prev_h = torch.cat([h_init[:, None], y.float()[:, :-1]], 1)
        da = (lam * prev_h).to(a.dtype)
        db = lam.to(ctx.b_dtype)
        dh0 = None if h0 is None else (af[:, 0] * lam[:, 0]).to(h0.dtype)
        return da, db, dh0

    @staticmethod
    def vmap(info, in_dims, a, b, h0):
        return vmap_by_folding(LruScan.apply, info, in_dims, (a, b, h0),
                               (True, True, True))


def scan(a, b, h0=None, *, use_kernel: bool = True):
    """a, b: (B, S, D); h0: (B, D) or None -> (y (B, S, D) in a.dtype,
    h_last (B, D) fp32)."""
    if use_kernel_for(a, use_kernel):
        return LruScan.apply(a, b, h0)
    return lru_scan_ref(a, b, h0)
