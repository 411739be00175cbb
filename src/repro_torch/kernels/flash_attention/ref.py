"""Plain PyTorch versions of the flash attention kernels.

Counterpart of ``repro/kernels/flash_attention/ref.py``: naive
materialized attention, fp32 scores, a finite ``NEG_INF`` and ``kv_len``
masking, in the reference's layout: q (B, H, Sq, Dh); k, v
(B, KV, Sk, Dh); query head h uses kv head h // (H // KV). Beside it, in
the kernels' own (model) layout, the forward with its row log-sum-exp
(``flash_attention_fwd_ref``) and the backward kernel's plain version
(``flash_attention_bwd_ref``), which the binding's stand-ins in the CPU
tests and the dry run's FLOP count use; and the same gradients summed in
the bf16 kernel's order (``flash_attention_bwd_fused_ref``), from its
tiling (``kernel.bwd_tiles``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import bwd_tiles

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        cap: float = 0.0, kv_len=None):
    B, H, Sq, Dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    R = H // KV
    kr = k.repeat_interleave(R, dim=1).float()
    vr = v.repeat_interleave(R, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * Dh ** -0.5
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    if kv_len is not None:
        mask &= (kpos < kv_len)[None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


def _scores(q, k, cap):
    """Scaled, soft-capped scores in fp32, (B, H, len q, len k), and the
    cap's derivative (1 with no cap); q (B, H, Sq', Dh), k (B, H, Sk',
    Dh)."""
    Dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * Dh ** -0.5
    capd = 1.0
    if cap:
        t = torch.tanh(s / cap)
        s, capd = cap * t, 1 - t * t
    return s, capd


def _visible(Sq, Sk, q0, nq, k0, nk, causal, window, kv_len, device):
    """The mask of query rows q0..q0+nq against keys k0..k0+nk."""
    qpos = torch.arange(q0, q0 + nq, device=device)[:, None]
    kpos = torch.arange(k0, k0 + nk, device=device)[None, :]
    ok = (qpos < Sq) & (kpos < Sk)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    if kv_len is not None:
        ok &= kpos < kv_len
    return ok


def _heads_first(q, k, v):
    """(B, S, heads, Dh) -> (B, heads, S, Dh) in fp32, k and v repeated to
    the query heads (head h uses kv head h // (H // KV))."""
    R = q.shape[2] // k.shape[2]
    return (q.transpose(1, 2).float(),
            k.transpose(1, 2).float().repeat_interleave(R, 1),
            v.transpose(1, 2).float().repeat_interleave(R, 1))


def flash_attention_fwd_ref(q, k, v, *, causal: bool = True, window: int = 0,
                            cap: float = 0.0, kv_len=None):
    """The kernel's forward with its row log-sum-exp, in the model's layout:
    q (B, Sq, H, Dh), k, v (B, Sk, KV, Dh) -> (o (B, Sq, H, Dh) in q's
    dtype, lse fp32 (B, H, Sq), the logsumexp of each row's scaled, capped,
    masked scores). Masked keys count as ``NEG_INF``, as in
    ``flash_attention_ref``."""
    Sq, Sk = q.shape[1], k.shape[1]
    qt, kt, vt = _heads_first(q, k, v)
    s, _ = _scores(qt, kt, cap)
    ok = _visible(Sq, Sk, 0, Sq, 0, Sk, causal, window, kv_len, q.device)
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, vt)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                            window: int = 0, cap: float = 0.0, kv_len=None,
                            block: int = 128):
    """The plain version of the backward kernel (csrc/flash_attention_bwd.cu):
    the gradients (dq, dk, dv) of ``flash_attention_fwd_ref`` for the output
    cotangent ``do``, from its ``o`` and ``lse``, tile by tile in the model's
    layout, in fp32. D = rowsum(do o o); per (query tile, key tile), over the
    whole tile grid: S = q k^T, P = exp(S - lse), dV += P^T do, dP = do v^T,
    dS = P (dP - D) (times 1 - (s / cap)^2 under the soft-cap), dQ += dS k,
    dK += dS^T q, dQ and dK scaled by Dh^-0.5. Five products a tile pair,
    10 B H Sq Sk Dh FLOP in all: what the binding reports. GQA's dk, dv are
    summed over each kv head's query heads. Gradients in the inputs'
    dtypes."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = Dh ** -0.5
    qt, kt, vt = _heads_first(q, k, v)
    gt = do.transpose(1, 2).float()
    D = (gt * o.transpose(1, 2).float()).sum(-1)
    dq, dk, dv = (torch.zeros_like(t) for t in (qt, kt, vt))
    for q0 in range(0, Sq, block):
        qs = slice(q0, min(q0 + block, Sq))
        for k0 in range(0, Sk, block):
            ks = slice(k0, min(k0 + block, Sk))
            s, capd = _scores(qt[:, :, qs], kt[:, :, ks], cap)
            ok = _visible(Sq, Sk, q0, s.shape[2], k0, s.shape[3], causal,
                          window, kv_len, q.device)
            p = torch.where(ok, torch.exp(s - lse[:, :, qs, None]), 0.0)
            dv[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd", p, gt[:, :, qs])
            dp = torch.einsum("bhqd,bhkd->bhqk", gt[:, :, qs], vt[:, :, ks])
            ds = p * (dp - D[:, :, qs, None]) * capd
            dq[:, :, qs] += torch.einsum("bhqk,bhkd->bhqd", ds,
                                         kt[:, :, ks]) * scale
            dk[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd", ds,
                                         qt[:, :, qs]) * scale
    R = H // KV
    dk = dk.view(B, KV, R, Sk, Dh).sum(2)
    dv = dv.view(B, KV, R, Sk, Dh).sum(2)
    return tuple(g.transpose(1, 2).to(t.dtype).contiguous()
                 for g, t in ((dq, q), (dk, k), (dv, v)))


def flash_attention_bwd_fused_ref(q, k, v, o, lse, do, *, causal: bool = True,
                                  window: int = 0, cap: float = 0.0,
                                  kv_len=None, per=None, slabs: int = 1):
    """``flash_attention_bwd_ref``'s gradients with every partial sum added
    in the bf16 kernel's fixed order, in fp32. Per key tile (``bwd_tiles``)
    and query tile, the last query tile first and the heads inside: dV +=
    P^T do and dK += dS^T q into the sum of the block that holds the head
    (blocks of ``per`` whole heads: one number for every key tile, or one
    a key tile; None: the whole group, one block a key tile; the kernel
    picks its own split by the card's SMs); a dQ part dS k, the sum of its
    64-key parts in key order, added to the query tile's running sum in
    slab n mod ``slabs`` in key-tile order. A key tile's block sums are
    then added in block order, the slabs in slab order; dQ and dK scaled
    by Dh^-0.5 at the end."""
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    R = H // KV
    key_tile, q_tile, _ = bwd_tiles(Dh)
    scale = Dh ** -0.5
    qt, kt, vt = _heads_first(q, k, v)
    gt = do.transpose(1, 2).float()
    D = (gt * o.transpose(1, 2).float()).sum(-1)
    dq = torch.zeros((slabs,) + qt.shape, dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, KV, Sk, Dh), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for n, k0 in enumerate(range(0, Sk, key_tile)):
        ks = slice(k0, min(k0 + key_tile, Sk))
        nk = ks.stop - k0
        heads = (R if per is None else per if isinstance(per, int)
                 else per[n])
        chunks = -(-R // heads)
        sum_k = torch.zeros((chunks, B, KV, nk, Dh), dtype=torch.float32,
                            device=q.device)
        sum_v = torch.zeros_like(sum_k)
        for q0 in reversed(range(0, Sq, q_tile)):
            qs = slice(q0, min(q0 + q_tile, Sq))
            s, capd = _scores(qt[:, :, qs], kt[:, :, ks], cap)
            ok = _visible(Sq, Sk, q0, s.shape[2], k0, nk, causal, window,
                          kv_len, q.device)
            p = torch.where(ok, torch.exp(s - lse[:, :, qs, None]), 0.0)
            dp = torch.einsum("bhqd,bhkd->bhqk", gt[:, :, qs], vt[:, :, ks])
            ds = torch.where(ok, p * (dp - D[:, :, qs, None]) * capd, 0.0)
            part = None
            for u0 in range(0, nk, 64):
                us = slice(u0, min(u0 + 64, nk))
                pu = torch.einsum("bhqk,bhkd->bhqd", ds[..., us],
                                  kt[:, :, ks][:, :, us])
                part = pu if part is None else part + pu
            dq[n % slabs, :, :, qs] += part
            cv = torch.einsum("bhqk,bhqd->bhkd", p, gt[:, :, qs])
            ck = torch.einsum("bhqk,bhqd->bhkd", ds, qt[:, :, qs])
            cv, ck = (c.view(B, KV, R, nk, Dh) for c in (cv, ck))
            for r in range(R):
                sum_v[r // heads] += cv[:, :, r]
                sum_k[r // heads] += ck[:, :, r]
        acc_k, acc_v = sum_k[0], sum_v[0]
        for c in range(1, chunks):
            acc_k, acc_v = acc_k + sum_k[c], acc_v + sum_v[c]
        dk[:, :, ks] = acc_k * scale
        dv[:, :, ks] = acc_v
    acc_q = dq[0]
    for g in range(1, slabs):
        acc_q = acc_q + dq[g]
    return tuple(g.transpose(1, 2).to(t.dtype).contiguous()
                 for g, t in ((acc_q * scale, q), (dk, k), (dv, v)))
