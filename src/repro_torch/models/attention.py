"""GQA attention: full / sliding-window, RoPE, decode against a cache.

Counterpart of ``repro/models/attention.py`` (``init_attention``,
``decode_attention``, ``attend``, ``init_cache``). Full-sequence attention
always goes through ``kernels.flash_attention.ops.attend``:
``cfg.use_pallas_attention`` keeps its meaning, "use the kernel", and
False asks for the plain version explicitly. A CPU tensor always takes
the plain version. Training differentiates the same call: the kernel's
backward is the VJP of its plain version (``ops.FlashAttention``). The
reference's jnp ``blocked_attention``, its training default with a
custom flash backward, computes the same function and is not ported
(ROADMAP queue 1, item 7b, with the encoder-decoder and VLM inputs).

Decode (one query against the cache) is plain PyTorch, as in the
reference, where it is no kernel either.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers

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
        return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))

    def forward(self, x, cfg: ModelConfig, *, mixer_kind: str,
                positions=None, cache=None, cache_pos=None):
        """x: (B, S, d). cache: dict(k, v) of (B, S_cache, KV, Dh) ->
        decode mode when S == 1 and ``cache_pos`` is given, else prefill
        (cache filled) or plain full-sequence. Returns (out, cache).

        The cache is written in place (slice assignment), where the
        reference returns an updated copy: the caller's dict is the one
        returned."""
        B, S, _ = x.shape
        window = cfg.window if mixer_kind == ATTN_LOCAL else 0
        use_rope = cfg.rope_on_global or mixer_kind == ATTN_LOCAL

        q = self._proj(x, self.wq)
        k = self._proj(x, self.wk)
        v = self._proj(x, self.wv)
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        if use_rope:
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)

        if cache is not None and cache_pos is not None and S == 1:
            # decode. Ring mode (local layers, cache length == window): the
            # write slot is pos % window and no extra window mask is needed.
            W = cache["k"].shape[1]
            ring = bool(window) and W == window
            slot = cache_pos % W if ring else cache_pos
            cache["k"][:, slot] = k[:, 0]
            cache["v"][:, slot] = v[:, 0]
            out = decode_attention(
                q, cache["k"], cache["v"],
                pos=min(cache_pos, W - 1) if ring else cache_pos,
                window=0 if ring else window, cap=cfg.attn_softcap)
        else:
            out = fa_ops.attend(q, k, v, causal=True, window=window,
                                cap=cfg.attn_softcap,
                                use_kernel=cfg.use_pallas_attention)
            if cache is not None:
                # prefill: populate the cache
                W = cache["k"].shape[1]
                ring = bool(window) and W == window
                if ring and S >= W:
                    # last W entries land at slots (abs_pos % W): a roll
                    cache["k"].copy_(torch.roll(k[:, -W:], S % W, dims=1))
                    cache["v"].copy_(torch.roll(v[:, -W:], S % W, dims=1))
                else:
                    cache["k"][:, :S] = k
                    cache["v"][:, :S] = v
        wo = self.wo
        y = out.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
        return y, cache


def decode_attention(q, k_cache, v_cache, *, pos: int, window: int = 0,
                     cap: float = 0.0):
    """One-token attention against a cache (``attention.py:340-363``).

    q: (B, 1, H, Dh); caches: (B, S, KV, Dh); pos: index of the current
    token (entries at >= pos+1 are invalid). Scores in fp32; p is cast to
    the cache dtype before the PV product, as in the reference."""
    B, _, H, Dh = q.shape
    S, KV = k_cache.shape[1], k_cache.shape[2]
    R = H // KV
    qg = q.reshape(B, KV, R, Dh)
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
