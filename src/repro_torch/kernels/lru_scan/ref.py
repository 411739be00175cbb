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
