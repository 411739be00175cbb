"""Plain PyTorch version of the WKV6 kernel, and the port's one source of
the RWKV-6 recurrence's math (``models/rwkv6.py`` imports it from here,
the reverse of the reference, where the kernel's oracle re-exports the
model's function).

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

Counterpart of ``repro/models/rwkv6.py::wkv6_ref`` (re-exported by
``repro/kernels/wkv6/ref.py``): a plain loop over time in fp32, split
into checkpointed chunks of the largest divisor of T up to ``chunk``
(64 by default; the kernel's backward asks for 128, as the reference's
``ops.mix`` does). Chunking changes no value; it bounds what the
backward stores to one state per chunk boundary, where differentiating
the plain loop stores a (B, H, N, N) state per step.

r, k, v: (B, T, H, N); w: (B, T, H, N), the decay in (0, 1); u: (H, N);
s0: (B, H, N, N) or None (zeros). Returns (o (B, T, H, N) in ``r.dtype``,
s_T (B, H, N, N) fp32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.wkv6.kernel import CHUNK, SUB


def _steps(s, rf, kf, vf, wf, uf):
    """The recurrence over the steps of rf (B, T, H, N) from state s, in
    fp32: (o (B, T, H, N), s_T)."""
    o = []
    for t in range(rf.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]      # (B, H, N, N)
        o.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], s + uf * kv))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(o, 1), s


def _chunk_fn(s, r, k, v, w, u):
    """One chunk of ``wkv6_ref`` from the fp32 state s: (o in r.dtype,
    s_T)."""
    o, s = _steps(s, r.float(), k.float(), v.float(), w.float(),
                  u.float()[None, :, :, None])
    return o.to(r.dtype), s


def _chunks(T: int, chunk: int) -> list:
    chunk = min(chunk, T)
    while T % chunk:          # the largest divisor <= chunk
        chunk -= 1
    return [slice(c0, c0 + chunk) for c0 in range(0, T, chunk)]


def _state0(r, s0):
    B, _, H, N = r.shape
    return (torch.zeros((B, H, N, N), dtype=torch.float32, device=r.device)
            if s0 is None else s0.float())


def _forward(r, k, v, w, u, s0, chunk: int):
    """The loop over chunks: (o, s_T, the state each chunk starts from)."""
    s, outs, bounds = _state0(r, s0), [], []
    for c in _chunks(r.shape[1], chunk):
        bounds.append(s)
        o, s = _chunk_fn(s, r[:, c], k[:, c], v[:, c], w[:, c], u)
        outs.append(o)
    return torch.cat(outs, 1), s, bounds


def wkv6_ref_vjp(cts, r, k, v, w, u, s0=None, chunk: int = 64):
    """The VJP of ``wkv6_ref`` at these inputs for the cotangents
    ``cts`` = (do, ds_T), as ``jax.checkpoint`` of each chunk gives it:
    the chunk-boundary states first, then each chunk run again under
    ``torch.func.vjp``, last chunk first. Returns the input gradients
    (None for an absent s0); the backward of ``wkv6_ref`` and of the
    kernel's ``ops.Wkv6``."""
    go, gs = cts
    if go is None or gs is None:
        raise RuntimeError("wkv6 backward: a cotangent is missing")
    cs = _chunks(r.shape[1], chunk)
    with torch.no_grad():
        *_, bounds = _forward(r, k, v, w, u, s0, chunk)
    grads, du = [], None
    for s, c in zip(reversed(bounds), reversed(cs)):
        _, vjp = torch.func.vjp(_chunk_fn, s, r[:, c], k[:, c], v[:, c],
                                w[:, c], u)
        gs, *g, du_c = vjp((go[:, c], gs))
        grads.append(g)
        du = du_c if du is None else du + du_c
    dr, dk, dv, dw = (torch.cat(x[::-1], 1) for x in zip(*grads))
    return dr, dk, dv, dw, du, None if s0 is None else gs.to(s0.dtype)


class _Wkv6Ref(torch.autograd.Function):
    """``wkv6_ref``: the forward keeps only its inputs, the backward is
    ``wkv6_ref_vjp`` (the checkpointed chunks of the reference). A
    ``Function`` rather than ``torch.utils.checkpoint``, which
    ``torch.func`` transforms refuse."""
    generate_vmap_rule = True

    @staticmethod
    def forward(r, k, v, w, u, s0, chunk):
        o, s, _ = _forward(r, k, v, w, u, s0, chunk)
        return o, s

    @staticmethod
    def setup_context(ctx, inputs, output):
        *tensors, s0, ctx.chunk = inputs
        ctx.has_s0 = s0 is not None
        ctx.save_for_backward(*tensors, *([s0] if ctx.has_s0 else []))

    @staticmethod
    def backward(ctx, go, gs):
        saved = list(ctx.saved_tensors)
        if not ctx.has_s0:
            saved.append(None)
        return (*wkv6_ref_vjp((go, gs), *saved, chunk=ctx.chunk), None)


def wkv6_ref(r, k, v, w, u, s0=None, chunk: int = 64):
    return _Wkv6Ref.apply(r, k, v, w, u, s0, chunk)


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
