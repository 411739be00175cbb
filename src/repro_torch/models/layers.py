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
class _Embed(torch.autograd.Function):
    """``table[tokens]`` with a backward that gives the same bits on every
    run, where the plain indexing backward may add the rows of repeated
    tokens with atomics on CUDA, in an order that varies from run to
    run. The rows of the cotangent are sorted stably by token, each
    token's rows are summed (in fp32 at least) by a pairwise tree in
    position order (``_segment_sums``), and each token's row of the
    gradient receives that sum and exact zeros, which any order of adds
    leaves the same. No global setting is touched."""
    generate_vmap_rule = True

    @staticmethod
    def forward(table, tokens):
        return table[tokens.long()]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, tokens = inputs
        ctx.save_for_backward(tokens)
        ctx.table_shape, ctx.table_dtype = table.shape, table.dtype

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        flat, order = torch.sort(tokens.reshape(-1).long(), stable=True)
        acc = torch.promote_types(g.dtype, torch.float32)
        rows = g.reshape(flat.numel(), -1)[order].to(acc)
        first, sums = _segment_sums(flat, rows)
        # every row but a run's first adds an exact zero
        grad = torch.zeros((ctx.table_shape[0], rows.shape[1]), dtype=acc,
                           device=g.device).index_put(
            (flat,), torch.where(first[:, None], sums, 0.0), accumulate=True)
        return grad.reshape(ctx.table_shape).to(ctx.table_dtype), None


def _segment_sums(keys, rows):
    """Over runs of equal ``keys`` (sorted): (a mask of each run's first
    position, ``rows`` with each run's sum at that position). The sum is
    a pairwise tree over the run in position order, one vectorized level
    per doubling, so its order depends on the data alone."""
    n = keys.numel()
    pos = torch.arange(n, device=keys.device)
    first = torch.cat([torch.ones_like(keys[:1], dtype=torch.bool),
                       keys[1:] != keys[:-1]])
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    # one past each run's last position: the next run's start
    nxt = torch.cat([torch.where(first, pos, n)[1:], pos[:1] * 0 + n])
    end = torch.cummin(nxt.flip(0), 0).values.flip(0)
    rank = pos - start
    step = 1
    while step < n:
        take = (rank % (2 * step) == 0) & (pos + step < end)
        shifted = torch.cat([rows[step:], torch.zeros_like(rows[:step])])
        rows = torch.where(take[:, None], rows + shifted, rows)
        step *= 2
    return first, rows


def apply_embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return _Embed.apply(table, tokens)


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
