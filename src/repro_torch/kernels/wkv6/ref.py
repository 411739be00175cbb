"""Plain PyTorch version of the WKV6 kernel, and the port's one source of
the RWKV-6 recurrence's math (``models/rwkv6.py`` imports it from here,
the reverse of the reference, where the kernel's oracle re-exports the
model's function).

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Counterpart of ``repro/models/rwkv6.py::wkv6_ref`` (re-exported by
``repro/kernels/wkv6/ref.py``), without its checkpointed chunking, which
only serves the backward: a plain loop over time in fp32.

r, k, v: (B, T, H, N); w: (B, T, H, N), the decay in (0, 1); u: (H, N);
s0: (B, H, N, N) or None (zeros). Returns (o (B, T, H, N) in ``r.dtype``,
s_T (B, H, N, N) fp32).
"""
from __future__ import annotations

import torch


def wkv6_ref(r, k, v, w, u, s0=None):
    B, T, H, N = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    o = torch.empty((B, T, H, N), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B, H, N, N)
        o[:, t] = torch.einsum("bhn,bhnm->bhm", rf[:, t], s + uf * kv)
        s = wf[:, t, :, :, None] * s + kv
    return o.to(r.dtype), s
