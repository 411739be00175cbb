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

from repro_torch.kernels.wkv6.kernel import CHUNK, SUB


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


def wkv6_chunked_ref(r, k, v, w, u, s0=None):
    """The same function in the chunked form of ``csrc/wkv6.cu``'s
    ``wkv6_chunked``, in plain PyTorch: it localises a fault of that
    kernel (its math against this, this against ``wkv6_ref``). Off the
    serving path.

    Per chunk of C = ``CHUNK`` steps, with P[t] = sum_{i<t} log2 w_i inside
    the chunk (P[0] = 0, all powers of 2):

        o_t = (r_t 2^{P[t]}) S_in + sum_{s<t} A[t,s] v_s + (r_t u k_t) v_t
        A[t,s] = sum_n r_t k_s 2^{P[t] - P[s+1]}
        S_out = diag(2^{P[C]}) S_in + sum_s (k_s 2^{P[C] - P[s+1]})^T v_s

    Every power has an exponent <= 0. A block of A between sub-chunks
    a < b of L = ``SUB`` steps is factored as (r_t 2^{P[t] - P[L b]})
    (2^{P[L b] - P[L(a+1)]}) (k_s 2^{P[L(a+1)] - P[s+1]}); a diagonal
    block is summed pair by pair. The naive split r_t 2^{P[t]} times
    k_s 2^{-P[s+1]} would overflow once -P passes 128. A step with w = 0
    adds nothing to P and a power across it is 0, as the kernel does: a
    huge log2 w in P would cost every later exponent its low bits. The
    ragged last chunk is padded with r = k = v = 0 and w = 1. Same
    arguments and returns as ``wkv6_ref``."""
    B, T, H, N = r.shape
    C, L = CHUNK, SUB
    dev = r.device
    # (B, H, T, N) fp32
    rf, kf, vf, wf = (t.float().transpose(1, 2) for t in (r, k, v, w))
    uf = u.float()[None, :, None, :]
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=dev)
         if s0 is None else s0.float().clone())
    o = torch.empty((B, H, T, N), dtype=torch.float32, device=dev)
    tt = torch.arange(L, device=dev)
    lower = (tt[None, :] < tt[:, None])[None, None, :, :, None]   # s < t
    blk = torch.arange(C, device=dev) // L
    for c0 in range(0, T, C):
        n = min(C, T - c0)
        pad = (0, 0, 0, C - n)
        rc, kc, vc = (torch.nn.functional.pad(x[:, :, c0:c0 + n], pad)
                      for x in (rf, kf, vf))
        wc = wf[:, :, c0:c0 + n]
        lw = torch.nn.functional.pad(
            torch.log2(torch.where(wc == 0, 1.0, wc)), pad)
        # P as above over the steps with w > 0; Z[t]: steps before t with w = 0
        P = torch.cat([torch.zeros_like(lw[:, :, :1]), lw.cumsum(2)], 2)
        Z = torch.nn.functional.pad((wc == 0).int().cumsum(2), (0, 0, 1, C - n))
        Z[:, :, n + 1:] = Z[:, :, n:n + 1]

        def pow2(i, j):
            """2^{P[i] - P[j]} for i >= j; 0 where a step with w = 0 lies
            between (Z differs)."""
            e = P[:, :, i] - P[:, :, j]
            return torch.exp2(e.masked_fill(Z[:, :, i] != Z[:, :, j],
                                            -float("inf")))

        rhat = rc * pow2(slice(0, C), L * blk)
        khat = kc * pow2(L * (blk + 1), slice(1, C + 1))
        A = torch.zeros((B, H, C, C), dtype=torch.float32, device=dev)
        for b in range(C // L):
            rows = slice(L * b, L * (b + 1))
            for a in range(b):
                cols = slice(L * a, L * (a + 1))
                mid = pow2(L * b, L * (a + 1))
                A[:, :, rows, cols] = torch.einsum(
                    "bhtn,bhsn->bhts", rhat[:, :, rows] * mid[:, :, None],
                    khat[:, :, cols])
            pairs = torch.where(lower, pow2((L * b + tt)[:, None],
                                            (L * b + 1 + tt)[None, :]), 0.0)
            A[:, :, rows, rows] = torch.einsum(
                "bhtn,bhsn,bhtsn->bhts", rc[:, :, rows], kc[:, :, rows], pairs)
            A[:, :, rows, rows] += torch.diag_embed(
                (rc[:, :, rows] * uf * kc[:, :, rows]).sum(-1))
        oc = A @ vc + (rc * pow2(slice(0, C), [0])) @ s
        o[:, :, c0:c0 + n] = oc[:, :, :n]
        kdec = kc * pow2([C], slice(1, C + 1))
        s = pow2(C, 0)[..., None] * s + kdec.transpose(2, 3) @ vc
    return o.transpose(1, 2).to(r.dtype), s
