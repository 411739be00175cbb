"""Plain PyTorch version of the LRU scan kernel.

    h_t = a_t * h_{t-1} + b_t      (elementwise over channels, fp32 state)

Counterpart of ``repro/kernels/lru_scan/ref.py``. a, b: (B, S, D) fp32 or
bf16; h0: (B, D) or None (zeros). Returns (y (B, S, D) in ``a.dtype``,
h_last (B, D) fp32). ``h_last`` is ``y[:, -1]`` widened to fp32, as the
TPU kernel returns it (``repro/kernels/lru_scan/kernel.py:67``); the JAX
oracle returns the unrounded state instead, which is the same number in
fp32 and one rounding apart in bf16.

A loop over time in fp32, one multiply and one add per step, which is
the kernel's own order of operations.

``lru_scan_bwd_ref`` is the plain version of the backward kernel
(``csrc/lru_scan_bwd.cu``): the reference's analytic backward
(``repro/kernels/lru_scan/ops.py:36-55``) as one loop over reversed time,
in the kernel's order.
"""
from __future__ import annotations

import torch


def lru_scan_ref(a, b, h0=None):
    B, S, D = a.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    y = torch.empty_like(a)
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        y[:, t] = h
    return y, y[:, -1].to(torch.float32, copy=True)


def lru_scan_bwd_ref(a, h0, y, gy, gh_last, b_dtype):
    """The gradients of ``lru_scan_ref`` at (a, h0), from its output y, for
    the cotangents gy (of y) and gh_last (of h_last). In fp32, one
    multiply then one add per step:

        lam_{S-1} = gy_{S-1} + gh_last,  lam_t = a_{t+1} lam_{t+1} + gy_t
        da_t = lam_t y_{t-1} (y_{-1} = h0 or 0),  db_t = lam_t,
        dh0 = a_0 lam_0

    Returns (da in a's dtype, db in ``b_dtype``, dh0 fp32 (B, D) or None
    where h0 is None), as the kernel's binding does."""
    S = a.shape[1]
    da = torch.empty_like(a)
    db = torch.empty(a.shape, dtype=b_dtype, device=a.device)
    lam = gy[:, -1].float() + gh_last.float()
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            lam = a[:, t + 1].float() * lam + gy[:, t].float()
        prev = (y[:, t - 1].float() if t > 0 else
                torch.zeros_like(lam) if h0 is None else h0.float())
        da[:, t] = lam * prev
        db[:, t] = lam
    dh0 = None if h0 is None else a[:, 0].float() * lam
    return da, db, dh0
