"""Shared layers: norm, RoPE, MLP, embedding, softcap.

Counterpart of ``repro/models/layers.py``. Parameters live in
``nn.Module``s; matmul weights are in ``cfg.dtype`` (bf16 by default),
norm scales stay fp32, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------- norms
class Norm(nn.Module):
    """LayerNorm or RMSNorm in fp32 with eps 1e-6 and the population
    variance, cast back to the input dtype (``layers.py:34-44``)."""

    def __init__(self, cfg: ModelConfig, dim: int, device=None):
        super().__init__()
        self.kind = cfg.norm_kind
        self.scale = nn.Parameter(torch.ones(dim, dtype=torch.float32,
                                             device=device))
        if self.kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(dim, dtype=torch.float32,
                                                 device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        xf = x.float()
        if self.kind == "layernorm":
            mu = xf.mean(-1, keepdim=True)
            var = (xf - mu).square().mean(-1, keepdim=True)
            y = (xf - mu) * torch.rsqrt(var + eps)
            y = y * self.scale + self.bias
        else:  # rmsnorm
            ms = xf.square().mean(-1, keepdim=True)
            y = xf * torch.rsqrt(ms + eps) * self.scale
        return y.to(x.dtype)


# ---------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split (not interleaved) RoPE with fp32 angles.

    x: (B, S, H, Dh); positions: broadcastable to (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (Dh/2,)
    ang = positions[..., None].float() * freqs                 # (B, S, Dh/2)
    ang = ang[..., None, :]                                    # (B, S, 1, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- MLP
class MLP(nn.Module):
    """Dense FFN: ``w_in (d, d_ff)``, ``w_out (d_ff, d)`` and, for
    swiglu, ``w_gate``. GeLU is the tanh approximation, which is what
    ``jax.nn.gelu`` computes by default (``layers.py:160``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = cdtype(cfg)
        self.kind = cfg.mlp_kind
        self.w_in = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff,
                                             dtype=dt, device=device))
        self.w_out = nn.Parameter(torch.empty(cfg.d_ff, cfg.d_model,
                                              dtype=dt, device=device))
        if self.kind == "swiglu":
            self.w_gate = nn.Parameter(torch.empty(cfg.d_model, cfg.d_ff,
                                                   dtype=dt, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        d_model, d_ff = self.w_in.shape
        normal_(self.w_in, generator, d_model ** -0.5)
        normal_(self.w_out, generator, d_ff ** -0.5)
        if self.kind == "swiglu":
            normal_(self.w_gate, generator, d_model ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.w_in
        if self.kind == "swiglu":
            h = F.silu(x @ self.w_gate) * h
        else:
            h = F.gelu(h, approximate="tanh")
        return h @ self.w_out


# ---------------------------------------------------------------- embed
def apply_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


# ---------------------------------------------------------------- init
@torch.no_grad()
def normal_(param: torch.Tensor, generator: torch.Generator,
            scale: float) -> None:
    """Fill ``param`` in place with N(0, 1) * scale drawn in fp32 on the
    parameter's own device, then cast, one tensor at a time (the
    reference draws fp32 normals and casts too)."""
    z = torch.randn(param.shape, generator=generator, dtype=torch.float32,
                    device=param.device)
    param.copy_(z.mul_(scale))
