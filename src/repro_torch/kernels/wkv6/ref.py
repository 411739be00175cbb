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

from repro_torch.kernels.wkv6.kernel import CHUNK, SUB, chunked


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
    (None for an absent s0); the backward of ``wkv6_ref`` (the plain
    route's)."""
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


def _powers(wc, C: int):
    """One chunk's decay powers as the chunked kernels form them. ``wc``
    (B, H, n, N) holds the chunk's n <= C decays; the chunk is padded to C
    steps with w = 1. Returns ``pow2(i, j)`` = 2^{P[i] - P[j]} = the
    product of w over the steps j .. i - 1 (i >= j), where P[t] sums log2 w
    over the steps before t that have w > 0, and a power across a step with
    w = 0 is 0 by its position (Z counts those steps): a huge log2 w in P
    would cost every later exponent its low bits."""
    n = wc.shape[2]
    pad = (0, 0, 0, C - n)
    lw = torch.nn.functional.pad(torch.log2(torch.where(wc == 0, 1.0, wc)),
                                 pad)
    P = torch.cat([torch.zeros_like(lw[:, :, :1]), lw.cumsum(2)], 2)
    Z = torch.nn.functional.pad((wc == 0).int().cumsum(2), (0, 0, 1, C - n))
    Z[:, :, n + 1:] = Z[:, :, n:n + 1]

    def pow2(i, j):
        e = P[:, :, i] - P[:, :, j]
        return torch.exp2(e.masked_fill(Z[:, :, i] != Z[:, :, j],
                                        -float("inf")))
    return pow2


def _pairs(pow2, b: int, L: int, dev):
    """(B, H, L, L, N): 2^{P[t] - P[s+1]} for the pairs s < t of sub-chunk
    b (t, s local), else 0: a diagonal block's factors, pair by pair."""
    tt = torch.arange(L, device=dev)
    lower = (tt[None, :] < tt[:, None])[None, None, :, :, None]
    return torch.where(lower, pow2((L * b + tt)[:, None],
                                   (L * b + 1 + tt)[None, :]), 0.0)


def _chunk_A(rc, kc, uf, pow2, C: int, L: int):
    """The forward's intra-chunk matrix A[t, s] = sum_n r_t k_s 2^{P[t] -
    P[s+1]} for s < t, r_t . (u o k_t) on the diagonal, 0 above: blocks
    between sub-chunks a < b factored about their boundaries, diagonal
    blocks pair by pair."""
    B, H, _, N = rc.shape
    blk = torch.arange(C, device=rc.device) // L
    rhat = rc * pow2(slice(0, C), L * blk)
    khat = kc * pow2(L * (blk + 1), slice(1, C + 1))
    A = torch.zeros((B, H, C, C), dtype=torch.float32, device=rc.device)
    for b in range(C // L):
        rows = slice(L * b, L * (b + 1))
        for a in range(b):
            cols = slice(L * a, L * (a + 1))
            mid = pow2(L * b, L * (a + 1))
            A[:, :, rows, cols] = torch.einsum(
                "bhtn,bhsn->bhts", rhat[:, :, rows] * mid[:, :, None],
                khat[:, :, cols])
        A[:, :, rows, rows] = torch.einsum(
            "bhtn,bhsn,bhtsn->bhts", rc[:, :, rows], kc[:, :, rows],
            _pairs(pow2, b, L, rc.device))
        A[:, :, rows, rows] += torch.diag_embed(
            (rc[:, :, rows] * uf * kc[:, :, rows]).sum(-1))
    return A


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
    adds nothing to P and a power across it is 0, as the kernel does
    (``_powers``). The ragged last chunk is padded with r = k = v = 0 and
    w = 1. Same arguments and returns as ``wkv6_ref``."""
    B, T, H, N = r.shape
    C, L = CHUNK, SUB
    dev = r.device
    # (B, H, T, N) fp32
    rf, kf, vf, wf = (t.float().transpose(1, 2) for t in (r, k, v, w))
    uf = u.float()[None, :, None, :]
    s = (torch.zeros((B, H, N, N), dtype=torch.float32, device=dev)
         if s0 is None else s0.float().clone())
    o = torch.empty((B, H, T, N), dtype=torch.float32, device=dev)
    for c0 in range(0, T, C):
        n = min(C, T - c0)
        pad = (0, 0, 0, C - n)
        rc, kc, vc = (torch.nn.functional.pad(x[:, :, c0:c0 + n], pad)
                      for x in (rf, kf, vf))
        pow2 = _powers(wf[:, :, c0:c0 + n], C)
        A = _chunk_A(rc, kc, uf, pow2, C, L)
        oc = A @ vc + (rc * pow2(slice(0, C), [0])) @ s
        o[:, :, c0:c0 + n] = oc[:, :, :n]
        kdec = kc * pow2([C], slice(1, C + 1))
        s = pow2(C, 0)[..., None] * s + kdec.transpose(2, 3) @ vc
    return o.transpose(1, 2).to(r.dtype), s


def _state_passes(kf, vf, rf, gf, wf, s, g, chunks):
    """The backward's two state passes over the chunks, as products of w:
    (a) each chunk's incoming state S_in, from s (s0 or zeros),
    S_out = diag(W) S_in + sum_s (k_s prod_{i>s} w_i)^T v_s; (b) each
    chunk's outgoing state gradient G_out, from g (ds_T), last chunk
    first, G_in = diag(W) G_out + sum_s (r_s prod_{i<s} w_i)^T do_s, with W
    the chunk's product of w. Every factor is a product of w, so a step
    with w = 0 needs no care. Returns (S_in list, G_out list, the first
    chunk's G_in: the gradient of s0)."""
    s_in = []
    for c in chunks:
        s_in.append(s)
        wc = wf[:, :, c]
        after = torch.cat([wc[:, :, 1:].flip(2).cumprod(2).flip(2),
                           torch.ones_like(wc[:, :, :1])], 2)  # prod_{i>s}
        s = (wc.prod(2)[..., None] * s
             + (kf[:, :, c] * after).transpose(2, 3) @ vf[:, :, c])
    g_out = [None] * len(chunks)
    for i in reversed(range(len(chunks))):
        c = chunks[i]
        g_out[i] = g
        wc = wf[:, :, c]
        before = torch.cat([torch.ones_like(wc[:, :, :1]),
                            wc[:, :, :-1].cumprod(2)], 2)      # prod_{i<s}
        g = (wc.prod(2)[..., None] * g
             + (rf[:, :, c] * before).transpose(2, 3) @ gf[:, :, c])
    return s_in, g_out, g


def _bwd_inputs(r, k, v, w, u, s0, do, ds_T):
    """(B, H, T, N) fp32 views of r, k, v, w, do; u as (1, H, 1, N); the
    chunks of ``CHUNK`` steps (the last one ragged); the state passes."""
    rf, kf, vf, wf, gf = (t.float().transpose(1, 2) for t in
                          (r, k, v, w, do))
    uf = u.float()[None, :, None, :]
    T = r.shape[1]
    chunks = [slice(c0, min(c0 + CHUNK, T)) for c0 in range(0, T, CHUNK)]
    passes = _state_passes(kf, vf, rf, gf, wf, _state0(r, s0),
                           ds_T.float(), chunks)
    return rf, kf, vf, wf, gf, uf, chunks, passes


def _dw_chunk(rc, kc, gc, vc, D, s_in, g_out, pow2, e, kfac):
    """dw over one chunk (padded to C steps) in the chunk form:

        dw_t[n] = sum_m G_t[n, m] S_{t-1}[n, m],
        S_{t-1} = 2^{P[t]} S_in + sum_{s<t} 2^{P[t]-P[s+1]} k_s^T v_s,
        G_t = 2^{P[C]-P[t+1]} G_out + sum_{s'>t} 2^{P[s']-P[t+1]} r_{s'}^T do_{s'},

    so dw_t is the sum of four parts: S_in with G_out (a row dot c), S_in
    with the do_{s'} (Z = do S_in^T, dr's first product), the v_s with
    G_out (Y = v G_out^T, dk's), and the pairs s < t < s' through D[s', s]
    = do_{s'} . v_s. Each power is factored about the sub-chunk boundaries
    (t in sub-chunk c, s in a <= c, s' in b >= c): between sub-chunks by
    the boundary factors, so the sums over s and s' there are dr's and
    dk's products between sub-chunks (M2, M1) and per-sub-chunk sums (RZ,
    KY, Q); inside sub-chunk c pair by pair. No power divides by w: exact
    at w = 0."""
    B, H, C, N = rc.shape
    L = SUB
    nb = C // L
    tt = torch.arange(C, device=rc.device)
    blk = tt // L
    re, kk = rc * e, kc * kfac
    Z = gc @ s_in.transpose(2, 3)        # Z[s', n] = (S_in do_{s'})[n]
    Y = vc @ g_out.transpose(2, 3)       # Y[s, n] = (G_out v_s)[n]
    cS = (s_in * g_out).sum(-1)[:, :, None]
    mid = {(a, b): pow2(L * b, L * (a + 1))[:, :, None]
           for b in range(nb) for a in range(b)}
    rows = [slice(L * b, L * (b + 1)) for b in range(nb)]
    # between sub-chunks: M2[s'] = sum_{a < c(s')} mid (D_{s',a} kk_a),
    # M1[s] = sum_{b > c(s)} mid (D_{b,s}^T re_b)
    M1, M2 = torch.zeros_like(rc), torch.zeros_like(rc)
    for b in range(nb):
        for a in range(b):
            Dba = D[:, :, rows[b], rows[a]]
            M2[:, :, rows[b]] += mid[a, b] * (Dba @ kk[:, :, rows[a]])
            M1[:, :, rows[a]] += mid[a, b] * (Dba.transpose(2, 3)
                                              @ re[:, :, rows[b]])
    RZ = [(re * Z)[:, :, r].sum(2, keepdim=True) for r in rows]
    KY = [(kk * Y)[:, :, r].sum(2, keepdim=True) for r in rows]
    dw = torch.zeros_like(rc)
    for c in range(nb):
        rw = rows[c]
        ec, kc_, pre, suf = (e[:, :, rw], kfac[:, :, rw],
                             pow2(L * c, 0)[:, :, None] * e[:, :, rw],
                             pow2(C, L * (c + 1))[:, :, None] * kfac[:, :, rw])
        late = sum((mid[c, b] * RZ[b] for b in range(c + 1, nb)),
                   torch.zeros_like(cS))
        early = sum((mid[a, c] * KY[a] for a in range(c)),
                    torch.zeros_like(cS))
        both = sum((mid[a, c] * mid[c, b] * (
            kk[:, :, rows[a]].unsqueeze(2) * re[:, :, rows[b]].unsqueeze(3)
            * D[:, :, rows[b], rows[a], None]).sum((2, 3))[:, :, None]
            for a in range(c) for b in range(c + 1, nb)), torch.zeros_like(cS))
        # pairs inside sub-chunk c: pr[t, s] = 2^{P[t] - P[s+1]}, s < t
        pr = _pairs(pow2, c, L, rc.device)
        rcc, kcc = rc[:, :, rw], kc[:, :, rw]
        Db = D[:, :, rw, rw]
        # sum_{s'>t} pr[s', t] x_{s'} and sum_{s<t} pr[t, s] x_s
        after = lambda x: torch.einsum("bhutn,bhun->bhtn", pr, x)
        before = lambda x: torch.einsum("bhtsn,bhsn->bhtn", pr, x)
        triple = torch.einsum("bhtsn,bhutn,bhsn,bhun,bhus->bhtn", pr, pr,
                              kcc, rcc, Db)
        dw[:, :, rw] = (
            pre * suf * cS
            + pre * (kc_ * late + after(rcc * Z[:, :, rw]))
            + suf * (ec * early + before(kcc * Y[:, :, rw]))
            + ec * kc_ * both + kc_ * before(kcc * M1[:, :, rw])
            + ec * after(rcc * M2[:, :, rw]) + triple)
    return dw


def _bwd_outputs(r, dr, dk, dv, dw, du_rows, ds0):
    back = [x.transpose(1, 2) for x in (dr, dk, dv, dw)]
    return (*(x.to(r.dtype).contiguous() for x in back[:3]),
            back[3].contiguous(), du_rows, ds0)


def wkv6_chunked_bwd_ref(r, k, v, w, u, s0, do, ds_T):
    """The plain version of the backward kernel's chunked route
    (``csrc/wkv6_bwd.cu``, ``kernel.chunked``: T >= 32 and N >= 16), pass
    for pass, in fp32: it localises a fault of that kernel, as
    ``wkv6_chunked_ref`` does for the forward. With G_t the gradient of the
    state after step t, G_{t-1} = diag(w_t) G_t + r_t^T do_t (G_T = ds_T):

        dr_t = do_t (S_{t-1} + diag(u) k_t^T v_t)^T
        dk_t = G_t v_t + u o r_t (v_t . do_t)
        dv_t = k_t G_t + (r_t . (u o k_t)) do_t
        dw_t[n] = sum_m G_t[n, m] S_{t-1}[n, m]
        du = sum_t r_t o k_t (v_t . do_t),   ds0 = G_{-1}

    (a), (b): the state passes (``_state_passes``). (c): per chunk of C =
    ``CHUNK`` steps, with P as in ``wkv6_chunked_ref``, D[t, s] = do_t .
    v_s and A the forward's intra-chunk matrix, three gradients are chunk
    products:

        dr_t = 2^{P[t]} o (S_in do_t) + sum_{s<t} 2^{P[t]-P[s+1]} o k_s D[t,s]
               + u o k_t D[t,t]
        dk_t = 2^{P[C]-P[t+1]} o (G_out v_t)
               + sum_{s>t} 2^{P[s]-P[t+1]} o r_s D[s,t] + u o r_t D[t,t]
        dv_t = (k_t o 2^{P[C]-P[t+1]}) G_out + sum_{s>=t} A[s,t] do_s

    each power factored about the sub-chunk boundaries as the forward's
    (exponents <= 0; a pair inside a sub-chunk on its own), and dw from
    the same pieces (``_dw_chunk``). The ragged last chunk is
    padded with r = k = v = do = 0 and w = 1. Returns the binding's
    outputs: (dr, dk, dv in r's dtype, dw fp32, du by batch row (B, H, N)
    fp32, ds0 (B, H, N, N) fp32)."""
    C, L = CHUNK, SUB
    nb = C // L
    rf, kf, vf, wf, gf, uf, chunks, (s_in, g_out, ds0) = _bwd_inputs(
        r, k, v, w, u, s0, do, ds_T)
    dev = rf.device
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    tt = torch.arange(C, device=dev)
    blk = tt // L
    for i, c in enumerate(chunks):
        n = c.stop - c.start
        pad = (0, 0, 0, C - n)
        rc, kc, vc, gc = (torch.nn.functional.pad(x[:, :, c], pad)
                          for x in (rf, kf, vf, gf))
        pow2 = _powers(wf[:, :, c], C)
        e = pow2(tt, L * blk)                        # 2^{P[t] - P[L b(t)]}
        kfac = pow2(L * (blk + 1), tt + 1)           # 2^{P[L (b+1)] - P[t+1]}
        D = gc @ vc.transpose(2, 3)                  # D[t, s] = do_t . v_s
        Dd = torch.diagonal(D, dim1=2, dim2=3)[..., None]
        drc = pow2(tt, [0]) * (gc @ s_in[i].transpose(2, 3)) + uf * kc * Dd
        dkc = (pow2([C], tt + 1) * (vc @ g_out[i].transpose(2, 3))
               + uf * rc * Dd)
        for b in range(nb):
            rows = slice(L * b, L * (b + 1))
            for a in range(b):      # s in sub-chunk a, t in b: dr_t
                cols = slice(L * a, L * (a + 1))
                mid = pow2(L * b, L * (a + 1))[:, :, None]
                drc[:, :, rows] += e[:, :, rows] * mid * (
                    D[:, :, rows, cols] @ (kc * kfac)[:, :, cols])
                dkc[:, :, cols] += kfac[:, :, cols] * mid * (
                    D[:, :, rows, cols].transpose(2, 3)
                    @ (rc * e)[:, :, rows])
            pairs = _pairs(pow2, b, L, dev)
            Db = D[:, :, rows, rows]
            drc[:, :, rows] += torch.einsum("bhts,bhsn,bhtsn->bhtn", Db,
                                            kc[:, :, rows], pairs)
            dkc[:, :, rows] += torch.einsum("bhts,bhtn,bhtsn->bhsn", Db,
                                            rc[:, :, rows], pairs)
        A = _chunk_A(rc, kc, uf, pow2, C, L)
        dvc = ((kc * pow2([C], tt + 1)) @ g_out[i]
               + A.transpose(2, 3) @ gc)
        dwc = _dw_chunk(rc, kc, gc, vc, D, s_in[i], g_out[i], pow2, e, kfac)
        dr[:, :, c], dk[:, :, c], dv[:, :, c], dw[:, :, c] = (
            x[:, :, :n] for x in (drc, dkc, dvc, dwc))
    du_rows = (rf * kf * (vf * gf).sum(-1, keepdim=True)).sum(2)
    return _bwd_outputs(r, dr, dk, dv, dw, du_rows, ds0)


def wkv6_recurrent_bwd_ref(r, k, v, w, u, s0, do, ds_T):
    """The plain version of the backward kernel's recurrent route (``not
    kernel.chunked``: T < 32 or N = 8), pass for pass: the state passes,
    then inside each chunk the step recurrence from S_in and G_out for
    every gradient, each state element on its own. Same arguments and
    returns as ``wkv6_chunked_bwd_ref``; the formulas are in its
    docstring."""
    rf, kf, vf, wf, gf, uf, chunks, (s_in, g_out, _) = _bwd_inputs(
        r, k, v, w, u, s0, do, ds_T)
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    for i, c in enumerate(chunks):
        s, hist = s_in[i], []
        for t in range(c.start, c.stop):
            hist.append(s)
            s = (wf[:, :, t, :, None] * s
                 + kf[:, :, t, :, None] * vf[:, :, t, None, :])
        g = g_out[i]
        for t in reversed(range(c.start, c.stop)):
            prev = hist[t - c.start]
            dk[:, :, t] = (g * vf[:, :, t, None, :]).sum(-1)
            dw[:, :, t] = (g * prev).sum(-1)
            dr[:, :, t] = (prev * gf[:, :, t, None, :]).sum(-1)
            dv[:, :, t] = (kf[:, :, t, :, None] * g).sum(-2)
            g = (wf[:, :, t, :, None] * g
                 + rf[:, :, t, :, None] * gf[:, :, t, None, :])
        if i == 0:
            ds0 = g
    vd = (vf * gf).sum(-1, keepdim=True)
    dr = dr + uf * kf * vd
    dk = dk + uf * rf * vd
    dv = dv + (rf * uf * kf).sum(-1, keepdim=True) * gf
    du_rows = (rf * kf * vd).sum(2)
    return _bwd_outputs(r, dr, dk, dv, dw, du_rows, ds0)


def wkv6_bwd_plain(r, k, v, w, u, s0, do, ds_T):
    """The plain version of the route the backward binding takes at this
    T and N (``kernel.chunked``)."""
    _, T, _, N = r.shape
    route = wkv6_chunked_bwd_ref if chunked(T, N) else wkv6_recurrent_bwd_ref
    return route(r, k, v, w, u, s0, do, ds_T)
