"""GQA attention: full / sliding-window, RoPE / M-RoPE, cross-attention,
decode against a cache.

Counterpart of ``repro/models/attention.py`` (``init_attention``,
``blocked_attention`` with its flash backward, ``decode_attention``,
``attend``, ``init_cache``). Full-sequence attention (train, prefill, the
encoder, cross-attention) routes as the reference's does
(``attention.py:403-411``): ``cfg.use_pallas_attention`` takes the
hand-written kernel through ``kernels.flash_attention.ops.attend`` (a CPU
tensor takes that kernel's plain version), False takes
``blocked_attention``: the reference's tiled online softmax in plain
PyTorch, whose backward (``_BlockedFlash``) recomputes each probability
tile from (q, k, v, lse) and never builds the (B, H, Sq, Sk) scores.

Decode (one query against the cache, or against the encoder states for
cross-attention) is plain PyTorch, as in the reference, where it is no
kernel either.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.kernels import is_dtensor, per_shard, split_axes
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers
from repro_torch.sharding.rules import P

NEG_INF = -1e30


class Attention(nn.Module):
    """Q/K/V/O projections in the reference's 3-D layout:
    wq (d, H, Dh), wk/wv (d, KV, Dh), wo (H, Dh, d)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = layers.cdtype(cfg)
        d, H, KV, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.resolved_head_dim)

        def w(*shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.wq, self.wk, self.wv = w(d, H, dh), w(d, KV, dh), w(d, KV, dh)
        self.wo = w(H, dh, d)

    def init_weights(self, generator: torch.Generator) -> None:
        d, H, dh = self.wq.shape
        for p in (self.wq, self.wk, self.wv):
            layers.normal_(p, generator, d ** -0.5)
        layers.normal_(self.wo, generator, (H * dh) ** -0.5)

    @staticmethod
    def _proj(x, w):
        # einsum("bsd,dhk->bshk"): one (B*S, d) x (d, H*Dh) product
        d, h, k = w.shape
        if is_dtensor(w):
            w2 = _MergeHeads.apply(_whole_dim(w, 2))
        else:
            w2 = w.reshape(d, h * k)
        return _heads_split(x @ w2, h).unflatten(-1, (h, k))

    def forward(self, x, cfg: ModelConfig, *, mixer_kind: str,
                positions=None, mrope_positions=None, causal: bool = True,
                cache=None, cache_pos=None, kv_override=None):
        """x: (B, S, d). cache: dict(k, v) of (B, S_cache, KV, Dh) ->
        decode mode when S == 1 and ``cache_pos`` is given, else prefill
        (cache filled) or plain full-sequence. ``mrope_positions``
        (3, B, S) replace ``positions`` when ``cfg.mrope``.
        ``kv_override`` (B, S_enc, d): cross-attention, k and v projected
        from the encoder states, no RoPE, no cache, not causal (decode at
        ``pos = S_enc - 1``). Returns (out, cache).

        The cache is written in place (slice assignment), where the
        reference returns an updated copy: the caller's dict is the one
        returned."""
        B, S, _ = x.shape
        window = cfg.window if mixer_kind == ATTN_LOCAL else 0
        use_rope = cfg.rope_on_global or mixer_kind == ATTN_LOCAL

        q = self._proj(x, self.wq)
        kin = x if kv_override is None else kv_override
        k = self._proj(kin, self.wk)
        v = self._proj(kin, self.wv)
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        if use_rope and kv_override is None:
            if cfg.mrope and mrope_positions is not None:
                q = layers.apply_mrope(q, mrope_positions, cfg.rope_theta)
                k = layers.apply_mrope(k, mrope_positions, cfg.rope_theta)
            else:
                q = layers.apply_rope(q, positions, cfg.rope_theta)
                k = layers.apply_rope(k, positions, cfg.rope_theta)

        if kv_override is not None:
            # cross-attention: bidirectional, the encoder's k/v recomputed
            # every call (the reference's choice: no cross cache)
            if S == 1:
                out = decode_attention(q, k, v, pos=k.shape[1] - 1,
                                       cap=cfg.attn_softcap)
            else:
                out = full_attention(q, k, v, cfg, causal=False, window=0)
        elif cache is not None and cache_pos is not None and S == 1:
            # decode. Ring mode (local layers, cache length == window): the
            # write slot is pos % window and no extra window mask is needed.
            W = cache["k"].shape[1]
            ring = bool(window) and W == window
            slot = cache_pos % W if ring else cache_pos
            _write_slot(cache["k"], slot, k[:, 0])
            _write_slot(cache["v"], slot, v[:, 0])
            out = decode_attention(
                q, cache["k"], cache["v"],
                pos=min(cache_pos, W - 1) if ring else cache_pos,
                window=0 if ring else window, cap=cfg.attn_softcap)
        else:
            out = full_attention(q, k, v, cfg, causal=causal, window=window)
            if cache is not None:
                # prefill: populate the cache
                W = cache["k"].shape[1]
                ring = bool(window) and W == window
                if ring and S >= W:
                    # last W entries land at slots (abs_pos % W): a roll
                    cache["k"].copy_(torch.roll(k[:, -W:], S % W, dims=1))
                    cache["v"].copy_(torch.roll(v[:, -W:], S % W, dims=1))
                elif is_dtensor(cache["k"]) and S == W:
                    cache["k"].copy_(k)
                    cache["v"].copy_(v)
                else:
                    cache["k"][:, :S] = k
                    cache["v"][:, :S] = v
        wo = _whole_dim(self.wo, 1)
        y = out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
        return y, cache


def _whole_dim(w, dim: int):
    """``w`` with dim ``dim`` unsplit: a ``DTensor`` split there is
    gathered on those mesh dims (a merged (H*Dh) dim can carry a split of
    its outer factor only); anything else as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
          for p in w.placements]
    return w if pl == list(w.placements) else w.redistribute(w.device_mesh,
                                                             pl)


class _MergeHeads(torch.autograd.Function):
    """``w.reshape(d, h * Dh)`` of a ``DTensor`` weight, whose gradient is
    split back into (h, Dh) through ``_heads_split``: the product's
    backward may split the merged dim where h does not divide."""

    @staticmethod
    def forward(ctx, w):
        d, h, k = w.shape
        ctx.h = h
        return w.reshape(d, h * k)

    @staticmethod
    def backward(ctx, g):
        return _heads_split(g, ctx.h).unflatten(-1, (ctx.h, -1))


def _heads_split(y, h: int, dim: int = -1):
    """``y`` ready to split its dim ``dim`` into (h, rest): a ``DTensor``
    split there by a mesh dim that does not divide ``h`` is gathered on
    that mesh dim; anything else as it is."""
    if not is_dtensor(y):
        return y
    from torch.distributed.tensor import Replicate, Shard
    mesh, dim = y.device_mesh, dim % y.dim()
    pl = [Replicate() if isinstance(p, Shard) and p.dim == dim
          and h % mesh.size(i) else p for i, p in enumerate(y.placements)]
    return y if pl == list(y.placements) else y.redistribute(mesh, pl)


def _write_slot(buf, slot: int, value) -> None:
    """``buf[:, slot] = value`` in place. On a ``DTensor`` cache, whose
    sequence dim may be sharded, each rank writes its own shard when the
    slot falls in it (the reference's ``dynamic_update_slice`` under
    GSPMD)."""
    if not is_dtensor(buf):
        buf[:, slot] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    mesh = buf.device_mesh
    coord = mesh.get_coordinate()
    # this rank's slice of the sequence dim (split in mesh-dim order)
    size, start = buf.shape[1], 0
    for i, p in enumerate(buf.placements):
        if isinstance(p, Shard) and p.dim == 1:
            size //= mesh.size(i)
            start += coord[i] * size
    # value (B, KV, Dh) is buf without dim 1: split as buf splits
    pl = tuple(Replicate() if not isinstance(p, Shard) or p.dim == 1
               else Shard(p.dim - (p.dim > 1)) for p in buf.placements)
    local = value.redistribute(mesh, pl).to_local() \
        if is_dtensor(value) else value
    if start <= slot < start + size:
        buf.to_local()[:, slot - start] = local


def full_attention(q, k, v, cfg: ModelConfig, *, causal: bool,
                   window: int):
    """Full-sequence attention, routed as the reference routes it: the
    kernel (``ops.attend``) when ``cfg.use_pallas_attention``, else
    ``blocked_attention``; ``cfg.attn_tp_repeat`` repeats k and v to the
    query heads first, ``cfg.attn_replicate_tp`` keeps every head on each
    rank of the ``model`` axis (``attention.py:395-409``)."""
    if cfg.attn_tp_repeat:
        # the GQA repeat materialized for the compute path only (caches
        # keep KV heads), so attention splits by heads on ``model``
        R = cfg.n_heads // cfg.n_kv_heads
        if R > 1 and k.shape[2] != cfg.n_heads:
            k = k.repeat_interleave(R, dim=2)
            v = v.repeat_interleave(R, dim=2)
    if cfg.use_pallas_attention:
        return fa_ops.attend(q, k, v, causal=causal, window=window,
                             cap=cfg.attn_softcap)
    return blocked_attention(
        q, k, v, causal=causal, window=window, cap=cfg.attn_softcap,
        tp_mode="replicate" if cfg.attn_replicate_tp else "auto")


# ------------------------------------------------- blocked attention
def _pad_to(x, n: int, dim: int):
    pad = n - x.shape[dim]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _tile_penalty(qpos, kpos, k_valid, causal: bool, window: int):
    """(qb, kb) fp32 additive mask: 0 where attendable, NEG_INF where
    not."""
    mask = k_valid[None, :]
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    return torch.where(mask, 0.0, NEG_INF).to(torch.float32)


def _key_blocks(qi: int, nq: int, nk: int, q_block: int, k_block: int,
                causal: bool, window: int) -> list:
    """The key blocks query block ``qi`` visits, in order
    (``attention.py:103-127``: the scan's trip set and its guard)."""
    hi = min((qi * q_block + q_block + k_block - 1) // k_block, nk) \
        if causal else nk
    lo = max((qi * q_block - window) // k_block, 0) if window else 0
    if window and causal:
        ks = range(lo, lo + min(nk, (window + q_block) // k_block + 1))
    else:
        ks = range(nk)
    return [ki for ki in ks if lo <= ki < hi]


def _query_blocks(ki: int, nq: int, q_block: int, k_block: int,
                  causal: bool, window: int) -> list:
    """The query blocks that see key block ``ki``, in order
    (``attention.py:239-255``)."""
    lo = (ki * k_block) // q_block if causal else 0
    if window and causal:
        hi = min((ki * k_block + k_block - 1 + window) // q_block + 1, nq)
        n_win = min(nq, (window + k_block) // q_block + 2)
        start = max(hi - n_win, 0)
        qs = range(start, start + n_win)
    else:
        hi = nq
        qs = range(nq)
    return [qi for qi in qs if lo <= qi < hi]


def _flash_fwd(qp, kp, vp, q_pos, k_pos, k_valid, causal, window, cap,
               scale):
    """qp (B, nq, qb, G, R, Dh); kp, vp (B, nk, kb, G, Dh). Returns out
    (nq, B, G, R, qb, Dh) fp32 and lse (nq, B, G, R, qb) fp32."""
    B, nq, qb, G, R, Dh = qp.shape
    nk, kb = kp.shape[1], kp.shape[2]
    dev = qp.device
    outs, lses = [], []
    for qi in range(nq):
        qblk = qp[:, qi].float()
        m = torch.full((B, G, R, qb), NEG_INF, device=dev)
        l = torch.zeros((B, G, R, qb), device=dev)
        acc = torch.zeros((B, G, R, qb, Dh), device=dev)
        for ki in _key_blocks(qi, nq, nk, qb, kb, causal, window):
            vblk = vp[:, ki]
            s = torch.einsum("bqgrd,bkgd->bgrqk", qblk,
                             kp[:, ki].float()) * scale
            if cap:
                s = layers.softcap(s, cap)
            s = s + _tile_penalty(q_pos[qi], k_pos[ki], k_valid[ki], causal,
                                  window)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bgrqk,bkgd->bgrqd",
                              p.to(vblk.dtype).float(), vblk.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        l_safe = l.clamp_min(1e-30)
        outs.append(acc / l_safe[..., None])
        lses.append(m + torch.log(l_safe))
    return torch.stack(outs), torch.stack(lses)


class _BlockedFlash(torch.autograd.Function):
    """The tiled forward; the backward recomputes each probability tile
    from (q, k, v, lse), one pass over the key blocks of each query block
    for dq, one over the query blocks of each key block for dk and dv
    (``attention.py:139-280``)."""

    @staticmethod
    def forward(qp, kp, vp, q_pos, k_pos, k_valid, scale, causal, window,
                cap):
        return _flash_fwd(qp, kp, vp, q_pos, k_pos, k_valid, causal,
                          window, cap, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        qp, kp, vp, q_pos, k_pos, k_valid, scale, causal, window, cap = \
            inputs
        outs, lses = output
        ctx.mark_non_differentiable(lses)
        ctx.save_for_backward(qp, kp, vp, outs, lses, q_pos, k_pos, k_valid)
        ctx.opts = (scale, causal, window, cap)

    @staticmethod
    def backward(ctx, douts, _dlse):
        qp, kp, vp, outs, lses, q_pos, k_pos, k_valid = ctx.saved_tensors
        scale, causal, window, cap = ctx.opts
        B, nq, qb, G, R, Dh = qp.shape
        nk, kb = kp.shape[1], kp.shape[2]
        douts = douts.float()
        Dv = (douts * outs).sum(-1)            # (nq, B, G, R, qb)

        def tile(qi, ki):
            """One probability tile and its score gradient."""
            s_pre = torch.einsum("bqgrd,bkgd->bgrqk", qp[:, qi].float(),
                                 kp[:, ki].float()) * scale
            s = layers.softcap(s_pre, cap) if cap else s_pre
            pen = _tile_penalty(q_pos[qi], k_pos[ki], k_valid[ki], causal,
                                window)
            # exp(NEG_INF - lse) underflows to exactly 0: masked entries
            p = torch.exp(s + pen - lses[qi][..., None])
            dp = torch.einsum("bgrqd,bkgd->bgrqk", douts[qi],
                              vp[:, ki].float())
            ds = p * (dp - Dv[qi][..., None])
            if cap:
                ds = ds * (1.0 - torch.square(s / cap))
            return p, ds * scale

        dq = []
        for qi in range(nq):
            acc = torch.zeros((B, qb, G, R, Dh), device=qp.device)
            for ki in _key_blocks(qi, nq, nk, qb, kb, causal, window):
                _, ds = tile(qi, ki)
                acc = acc + torch.einsum("bgrqk,bkgd->bqgrd", ds,
                                         kp[:, ki].float())
            dq.append(acc)
        dk, dv = [], []
        for ki in range(nk):
            dk_acc = torch.zeros((B, kb, G, Dh), device=qp.device)
            dv_acc = torch.zeros((B, kb, G, Dh), device=qp.device)
            for qi in _query_blocks(ki, nq, qb, kb, causal, window):
                p, ds = tile(qi, ki)
                dv_acc = dv_acc + torch.einsum("bgrqk,bgrqd->bkgd", p,
                                               douts[qi])
                dk_acc = dk_acc + torch.einsum("bgrqk,bqgrd->bkgd", ds,
                                               qp[:, qi].float())
            dk.append(dk_acc)
            dv.append(dv_acc)
        return (torch.stack(dq, 1).to(qp.dtype),
                torch.stack(dk, 1).to(kp.dtype),
                torch.stack(dv, 1).to(vp.dtype),
                None, None, None, None, None, None, None)


def blocked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      cap: float = 0.0, q_offset: int = 0,
                      q_block: int = 512, k_block: int = 1024,
                      kv_len=None, tp_mode: str = "auto"):
    """Flash-style blocked attention with a flash backward
    (``attention.py:288-337``).

    q: (B, Sq, H, Dh); k, v: (B, Sk, KV, Dh). GQA by grouping query
    heads (no materialized KV repeat). Returns (B, Sq, H, Dh). window > 0
    masks keys ``window`` or more positions behind the query; ``kv_len``
    (an int) masks keys at positions >= kv_len.

    ``DTensor`` inputs run per shard, the reference's constraint on the
    tiles (``attention.py:319-327``): batch on the data axes and, with
    ``tp_mode="auto"``, whole KV groups on ``model`` when it divides KV;
    otherwise (or with ``"replicate"``) every head on each rank. The
    reference's head_dim fallback, which all-reduces each score tile, is
    not taken: the heads are gathered instead."""
    if is_dtensor(q):
        b, m = split_axes(q, q.shape[0], q.shape[2], k.shape[2])
        spec = P(b, None, None if tp_mode == "replicate" else m)
        return per_shard(
            lambda q_, k_, v_: blocked_attention(
                q_, k_, v_, causal=causal, window=window, cap=cap,
                q_offset=q_offset, q_block=q_block, k_block=k_block,
                kv_len=kv_len),
            (q, k, v), (spec,) * 3, (spec,))
    B, Sq, H, Dh = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G, R = KV, H // KV
    q_block, k_block = min(q_block, Sq), min(k_block, Sk)
    nq, nk = -(-Sq // q_block), -(-Sk // k_block)
    qp = _pad_to(q, nq * q_block, 1).reshape(B, nq, q_block, G, R, Dh)
    kp = _pad_to(k, nk * k_block, 1).reshape(B, nk, k_block, G, Dh)
    vp = _pad_to(v, nk * k_block, 1).reshape(B, nk, k_block, G, Dh)
    dev = q.device
    q_pos = (torch.arange(nq * q_block, device=dev)
             + q_offset).reshape(nq, q_block)
    k_pos = torch.arange(nk * k_block, device=dev).reshape(nk, k_block)
    k_valid = k_pos < (Sk if kv_len is None else kv_len)
    outs, _ = _BlockedFlash.apply(qp, kp, vp, q_pos, k_pos, k_valid,
                                  Dh ** -0.5, causal, window, cap)
    out = outs.to(q.dtype).movedim(0, 1)               # (B, nq, G, R, qb, Dh)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * q_block, H, Dh)
    return out[:, :Sq]


def decode_attention(q, k_cache, v_cache, *, pos: int, window: int = 0,
                     cap: float = 0.0):
    """One-token attention against a cache (``attention.py:340-363``).

    q: (B, 1, H, Dh); caches: (B, S, KV, Dh); pos: index of the current
    token (entries at >= pos+1 are invalid). Scores in fp32; p is cast to
    the cache dtype before the PV product, as in the reference."""
    B, _, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    R = H // KV
    qg = _heads_split(q, KV, 2).reshape(B, KV, R, Dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg.float(),
                     k_cache.float()) * Dh ** -0.5
    if cap:
        s = layers.softcap(s, cap)
    kpos = torch.arange(S, device=q.device)
    mask = kpos <= pos
    if window:
        mask &= kpos > pos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrk,bkgd->bgrd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, Dh).to(q.dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               window: int = 0, device=None):
    """window > 0 with cfg.ring_cache -> ring cache of exactly ``window``
    entries (local-attention layers never need more)."""
    dh = cfg.resolved_head_dim
    dt = layers.cdtype(cfg)
    length = max_len
    if window and cfg.ring_cache and window < max_len:
        length = window
    shape = (batch, length, cfg.n_kv_heads, dh)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
