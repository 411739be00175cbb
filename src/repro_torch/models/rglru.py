"""RecurrentGemma / Griffin recurrent block: temporal conv + RG-LRU.

RG-LRU recurrence (per channel):
    r_t = sigmoid(x_t W_a + b_a)               (recurrence gate)
    i_t = sigmoid(x_t W_i + b_i)               (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)     (data-dependent decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Counterpart of ``repro/models/rglru.py``. Sequence mode runs the
recurrence through ``kernels.lru_scan.ops.scan``, the hand-written kernel
on a CUDA tensor, where the reference computes the same function with a
chunked ``associative_scan``; the reference folds ``h0`` into ``b[:, 0]``
and the port hands it to the scan, which computes a_0 h0 + b_0 itself.
Decode is the plain one-step update, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.lru_scan import ops as lru_ops
from repro_torch.models import layers
from repro_torch.sharding.constraints import constrain


class RGLRU(nn.Module):
    """The reference's parameter names and dtypes: branch, conv and output
    weights in ``cfg.dtype``; gate weights, biases and ``lambda_param`` in
    fp32 (``rglru.py:25-44``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = layers.cdtype(cfg)
        D = cfg.d_model
        f32 = torch.float32

        def p(shape, dtype):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        self.w_x_branch = p((D, D), dt)
        self.w_gate_branch = p((D, D), dt)
        self.conv_w = p((cfg.conv_width, D), dt)
        self.conv_b = nn.Parameter(torch.zeros(D, dtype=f32, device=device))
        self.w_a = p((D, D), f32)
        self.b_a = nn.Parameter(torch.zeros(D, dtype=f32, device=device))
        self.w_i = p((D, D), f32)
        self.b_i = nn.Parameter(torch.zeros(D, dtype=f32, device=device))
        self.lambda_param = p((D,), f32)
        self.w_out = p((D, D), dt)
        self.rglru_c = cfg.rglru_c

    def init_weights(self, generator: torch.Generator) -> None:
        D = self.w_out.shape[0]
        s = D ** -0.5
        for w in (self.w_x_branch, self.w_gate_branch, self.w_a, self.w_i,
                  self.w_out):
            layers.normal_(w, generator, s)
        layers.normal_(self.conv_w, generator, 0.1)
        # Lambda so that a^c lies in [0.9, 0.999] at r = 1 (Griffin
        # appendix): lam ~ U[0.9^2, 0.999^2], Lambda = softplus^-1(
        # -log(lam) / (2c)).
        lam = torch.rand(D, generator=generator, dtype=torch.float32,
                         device=self.lambda_param.device)
        lam = 0.9 ** 2 + (0.999 ** 2 - 0.9 ** 2) * lam
        self.lambda_param.copy_(
            torch.log(torch.expm1(-torch.log(lam) / (2 * self.rglru_c))))


def _gates(params: RGLRU, x, cfg: ModelConfig):
    """a_t (decay) and gated input, both fp32. x: (..., D). The gate
    products are plain fp32 matmuls, as in the reference."""
    xf = x.float()
    r = torch.sigmoid(xf @ params.w_a + params.b_a)
    i = torch.sigmoid(xf @ params.w_i + params.b_i)
    log_a = -cfg.rglru_c * F.softplus(params.lambda_param) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2 * log_a), min=1e-12)) \
        * (i * xf)
    return a, gated


def rglru_scan(params: RGLRU, x, cfg: ModelConfig, h0=None):
    """x: (B, S, D) -> (y in x.dtype, h_last (B, D) fp32)."""
    a, b = _gates(params, x, cfg)                          # (B, S, D) fp32
    a = constrain(a, "batch", None, "dsq")
    b = constrain(b, "batch", None, "dsq")
    y, h_last = lru_ops.scan(a, b, h0, use_kernel=cfg.use_pallas_attention)
    return y.to(x.dtype), h_last


def rglru_step(params: RGLRU, x, cfg: ModelConfig, h):
    """One decode step. x: (B, 1, D); h: (B, D) fp32."""
    a, b = _gates(params, x[:, 0], cfg)
    h_new = a * h + b
    return h_new.to(x.dtype)[:, None], h_new


def _causal_conv(params: RGLRU, x, cfg: ModelConfig, conv_cache=None):
    """Depthwise causal temporal conv of width ``cfg.conv_width``, summed
    in fp32. x: (B, S, D); conv_cache: (B, width-1, D), the previous
    inputs (decode). Returns (y in x.dtype, new conv cache)."""
    W = cfg.conv_width
    if conv_cache is not None:
        xc = torch.cat([conv_cache.to(x.dtype), x], dim=1)
    else:
        xc = F.pad(x, (0, 0, W - 1, 0))
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        y = y + xc[:, i:i + S].float() * params.conv_w[i].float()
    y = y + params.conv_b
    new_cache = xc[:, -(W - 1):].clone() if W > 1 else None
    return y.to(x.dtype), new_cache


def apply_rglru_block(params: RGLRU, x, cfg: ModelConfig, cache=None):
    """Griffin recurrent block. x: (B, S, D); cache: {"h": (B, D) fp32,
    "conv": (B, width-1, D)} or None. Returns (y, new_cache): new tensors,
    the caller's cache is not written."""
    gate = F.gelu(x @ params.w_gate_branch, approximate="tanh")
    u = x @ params.w_x_branch
    conv_cache = cache["conv"] if cache is not None else None
    u, new_conv = _causal_conv(params, u, cfg, conv_cache)
    if cache is not None and x.shape[1] == 1:
        y, h_last = rglru_step(params, u, cfg, cache["h"])
    else:
        h0 = cache["h"] if cache is not None else None
        y, h_last = rglru_scan(params, u, cfg, h0)
    out = (gate * y) @ params.w_out
    new_cache = {"h": h_last}
    if new_conv is not None:
        new_cache["conv"] = new_conv
    return out, new_cache


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> dict:
    return {
        "h": torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_model),
                            dtype=layers.cdtype(cfg), device=device),
    }

