"""RWKV-6 "Finch" time-mix with data-dependent decay. [arXiv:2404.05892]

Per head (dim N), state S in R^{N x N}:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with data-dependent decay w_t = exp(-exp(w0 + tanh(x W_w1) W_w2)) (the
low-rank "Finch" decay) and a token-shift lerp on the r/k/v/w/g inputs.

Counterpart of ``repro/models/rwkv6.py``, with the reference's documented
simplifications (static per-channel token-shift lerp, SiLU output gate).
The recurrence runs through ``kernels.wkv6.ops.mix`` in prefill and in
decode (T = 1), the hand-written kernel on a CUDA tensor; its plain
version ``wkv6_ref`` lives in ``kernels/wkv6/ref.py`` and is the one
source of the recurrence's math in the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.wkv6 import ops as wkv_ops
# re-exported under the reference's name (repro.models.rwkv6.wkv6_ref)
from repro_torch.kernels.wkv6.ref import wkv6_ref  # noqa: F401
from repro_torch.models import layers
from repro_torch.sharding.constraints import constrain

DECAY_RANK = 64


class RWKV6(nn.Module):
    """The reference's parameter names and dtypes: r/k/v/g/o projections in
    ``cfg.dtype``; ``mu``, ``w0``, the decay LoRA, ``u`` and the per-head
    norm scale in fp32 (``rwkv6.py:32-53``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = layers.cdtype(cfg)
        D, H, N = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
        if H * N != D:
            raise ValueError("rwkv6 requires n_heads * head_dim == d_model")
        f32 = torch.float32

        def p(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        self.mu = nn.Parameter(torch.full((5, D), 0.5, dtype=f32,
                                          device=device))
        self.w_r, self.w_k, self.w_v, self.w_g, self.w_o = (
            p((D, D), dt) for _ in range(5))
        self.w0 = nn.Parameter(torch.full((D,), -6.0, dtype=f32,
                                          device=device))
        self.w_lora_a = p((D, DECAY_RANK), f32)
        self.w_lora_b = p((DECAY_RANK, D), f32)
        self.u = p((H, N), f32)
        self.ln_scale = nn.Parameter(torch.ones((H, N), dtype=f32,
                                                device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        s = self.w_r.shape[0] ** -0.5
        for w in (self.w_r, self.w_k, self.w_v, self.w_g, self.w_o,
                  self.w_lora_a):
            layers.normal_(w, generator, s)
        layers.normal_(self.w_lora_b, generator, DECAY_RANK ** -0.5)
        layers.normal_(self.u, generator, 0.1)


def _token_shift(x, mu, x_prev=None):
    """lerp(x, shift(x), mu) for 5 streams. x: (B, S, D); mu: (5, D);
    x_prev: (B, 1, D), the token before x (decode) or None (zeros)."""
    if x_prev is None:
        xs = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        xs = torch.cat([x_prev.to(x.dtype), x], dim=1)[:, :-1]
    return x[None] + mu[:, None, None, :].to(x.dtype) * (xs - x)[None]


def _project(params: RWKV6, x, cfg: ModelConfig, x_prev=None):
    """Token shift + projections. Returns r, k, v, w (B, S, H, N), with w
    the fp32 decay in (0, 1), and g (B, S, D)."""
    B, S, D = x.shape
    H, N = cfg.n_heads, cfg.resolved_head_dim
    xr, xk, xv, xw, xg = _token_shift(x, params.mu, x_prev)
    r = (xr @ params.w_r).reshape(B, S, H, N)
    k = (xk @ params.w_k).reshape(B, S, H, N)
    v = (xv @ params.w_v).reshape(B, S, H, N)
    g = F.silu(xg @ params.w_g)
    dec = params.w0 + torch.tanh(xw.float() @ params.w_lora_a) \
        @ params.w_lora_b
    w = torch.exp(-torch.exp(dec)).reshape(B, S, H, N)
    return r, k, v, w, g


def _head_norm(params: RWKV6, o):
    """Per-head RMS group norm. o: (B, S, H, N) fp32."""
    ms = o.square().mean(-1, keepdim=True)
    return o * torch.rsqrt(ms + 1e-6) * params.ln_scale


def apply_rwkv6_block(params: RWKV6, x, cfg: ModelConfig, cache=None):
    """x: (B, S, D); cache: {"state": (B, H, N, N) fp32, "xprev": (B, 1, D)}
    or None. Returns (y, new_cache): new tensors, the caller's cache is not
    written."""
    B, S, D = x.shape
    x_prev = cache["xprev"] if cache is not None else None
    s0 = cache["state"] if cache is not None else None
    r, k, v, w, g = _project(params, x, cfg, x_prev)
    r, k, v, w = (constrain(t, "batch", None, "heads", None)
                  for t in (r, k, v, w))
    o, s_T = wkv_ops.mix(r, k, v, w, params.u, s0,
                         use_kernel=cfg.use_pallas_attention)
    o = _head_norm(params, o.float())
    o = o.reshape(B, S, D).to(x.dtype) * g
    y = o @ params.w_o
    return y, {"state": s_T, "xprev": x[:, -1:].clone()}


def init_rwkv6_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    H, N = cfg.n_heads, cfg.resolved_head_dim
    return {
        "state": torch.zeros((batch, H, N, N), dtype=torch.float32,
                             device=device),
        "xprev": torch.zeros((batch, 1, cfg.d_model),
                             dtype=layers.cdtype(cfg), device=device),
    }
