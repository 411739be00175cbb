"""Public wrapper for the WKV6 kernel.

Counterpart of ``repro/kernels/wkv6/ops.py::mix``: routes a CUDA tensor
through the hand-written kernel (or, only when the caller asks with
``use_kernel=False``, the plain version) and a CPU tensor through the
plain version. Any T, T = 1 (a decode step) included: the TPU kernel's
chunk divisibility does not carry over.

Forward only: the reference's backward (the VJP of the chunked oracle)
waits for the training slice.
"""
from __future__ import annotations

from repro_torch.kernels import use_kernel_for
from repro_torch.kernels.wkv6 import kernel
from repro_torch.kernels.wkv6.ref import wkv6_ref


def mix(r, k, v, w, u, s0=None, *, use_kernel: bool = True):
    """r, k, v, w: (B, T, H, N); u: (H, N); s0: (B, H, N, N) or None ->
    (o (B, T, H, N) in r.dtype, s_T (B, H, N, N) fp32)."""
    if use_kernel_for(r, use_kernel):
        return kernel.wkv6(r.contiguous(), k.contiguous(), v.contiguous(),
                           w, u, s0)
    return wkv6_ref(r, k, v, w, u, s0)
