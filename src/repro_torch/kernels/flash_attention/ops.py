"""Public wrapper for the flash attention kernel.

Counterpart of ``repro/kernels/flash_attention/ops.py::attend``: accepts
the model's (B, S, H, Dh) layout and routes. A CUDA tensor goes straight
to the hand-written kernel, which reads that layout and masks the ragged
last tile itself: no transpose, pad or copy, and the output is the
model's layout. A CPU tensor (or a CUDA one with ``use_kernel=False``)
takes the plain version the reference's way: transposed to
(B, H, S, Dh) and padded to a block multiple, with ``kv_len`` set only
when padding happened. Padding changes no real row: padded keys are
masked by ``kv_len`` and padded query rows are sliced away, so both
routes compute one function.

Forward only: the reference's backward (the VJP of ``ref.py``) waits for
the training slice.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels import use_kernel_for
from repro_torch.kernels.flash_attention import kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def attend(q, k, v, *, causal: bool = True, window: int = 0,
           cap: float = 0.0, bq: int = 128, bk: int = 128,
           use_kernel: bool = True):
    """q: (B, S, H, Dh); k, v: (B, S, KV, Dh) -> (B, S, H, Dh)."""
    if use_kernel_for(q, use_kernel):
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      cap=cap)
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
