"""Public wrapper for the LRU scan kernel.

Counterpart of ``repro/kernels/lru_scan/ops.py::scan``: routes a CUDA
tensor through the hand-written kernel (or, only when the caller asks
with ``use_kernel=False``, the plain version) and a CPU tensor through
the plain version. Any S and D: the TPU kernel's chunk and block
divisibility does not carry over.

Forward only: the reference's backward (the same scan run in reversed
time, ``repro/kernels/lru_scan/ops.py:36-55``) waits for the training
slice.
"""
from __future__ import annotations

from repro_torch.kernels import use_kernel_for
from repro_torch.kernels.lru_scan import kernel
from repro_torch.kernels.lru_scan.ref import lru_scan_ref


def scan(a, b, h0=None, *, use_kernel: bool = True):
    """a, b: (B, S, D); h0: (B, D) or None -> (y (B, S, D) in a.dtype,
    h_last (B, D) fp32)."""
    if use_kernel_for(a, use_kernel):
        return kernel.lru_scan(a.contiguous(), b.contiguous(),
                               None if h0 is None else h0.contiguous())
    return lru_scan_ref(a, b, h0)
