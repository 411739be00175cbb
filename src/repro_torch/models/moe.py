"""Mixture-of-Experts FFN: GShard/Switch-style capacity dispatch.

Counterpart of ``repro/models/moe.py`` (``init_moe``, ``apply_moe``).
The weights keep the reference's names and shapes (``router`` (D, E)
fp32; ``w_in``, ``w_gate`` (E, D, F); ``w_out`` (E, F, D); ``shared``,
an ``MLP`` of width F, when ``cfg.shared_expert``), so
``bridge.backbone_params_from_jax`` carries them as they are.

``apply_moe`` follows the reference step for step: the tokens padded
with zeros to groups of ``moe_group_size``; an fp32 router softmax;
top-k with the reference's tie-break (``route``); for K > 1 the gates
renormalized with a 1e-9 floor; ``cap = max(1, int(G K cf / E))`` slots
per expert and group, numbered by an exclusive cumsum in token-major,
k-minor order, a (token, k) kept when its slot is below ``cap``; the
dispatch and combine tensors in ``x.dtype``; the expert FFN as batched
products; the shared expert on the padded groups; and the Switch
load-balance loss over all n·G rows, the padding included.

The reference's ``init_moe`` always draws ``w_gate``, so its expert FFN
always takes the ``silu(g)·h`` branch; its gelu branch never runs and is
not ported. The expert FFN runs under a nested
``torch.utils.checkpoint`` where a gradient is taken, the counterpart of
the reference's ``jax.checkpoint`` (memory only: the same bits).

A token's slot, and whether it is dropped, depend on the tokens before
it in its group, so its output depends on the batch it came in: that is
the reference's semantics, kept. The MoE has no Pallas kernel in the
reference; its einsums are plain products here too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import is_dtensor, per_shard, split_axes
from repro_torch.models import layers
from repro_torch.sharding.constraints import constrain
from repro_torch.sharding.rules import P


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = layers.cdtype(cfg)
        E, D, Fh = cfg.n_experts, cfg.d_model, cfg.d_ff

        def w(*shape, dtype=dt):
            return nn.Parameter(torch.empty(shape, dtype=dtype,
                                            device=device))

        self.router = w(D, E, dtype=torch.float32)
        self.w_in = w(E, D, Fh)
        self.w_gate = w(E, D, Fh)
        self.w_out = w(E, Fh, D)
        if cfg.shared_expert:
            self.shared = layers.MLP(cfg, d_ff=Fh, device=device)

    def init_weights(self, generator: torch.Generator) -> None:
        """The reference's scales: D^-0.5 for the router, ``w_in`` and
        ``w_gate``, F^-0.5 for ``w_out``."""
        D, Fh = self.w_in.shape[1:]
        for p in (self.router, self.w_in, self.w_gate):
            layers.normal_(p, generator, D ** -0.5)
        layers.normal_(self.w_out, generator, Fh ** -0.5)
        if hasattr(self, "shared"):
            self.shared.init_weights(generator)

    def forward(self, x, cfg: ModelConfig):
        """x: (B, S, D) -> (y, aux); ``cfg.moe_impl`` picks the capacity
        dispatch or the dropless one (``backbone.py:110-116``)."""
        if cfg.moe_impl == "dropless":
            from repro_torch.models.moe_dropless import apply_moe_dropless
            return apply_moe_dropless(self, x, cfg)
        return apply_moe(self, x, cfg)


def route(x, router, k: int):
    """(probs, gate_vals, gate_idx) of tokens ``x`` (..., D): the fp32
    router softmax and its k largest entries, equal values in order of
    the lowest expert first, as ``jax.lax.top_k`` orders them (a padded
    zero token's probs are all equal and pick experts 0..k-1). A stable
    descending sort gives that order on every device, where
    ``torch.topk`` promises none. For k > 1 the gates are renormalized
    with the reference's 1e-9 floor."""
    probs = torch.softmax(x.float() @ router, dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    vals = probs.gather(-1, idx)
    if k > 1:
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, vals, idx


def load_balance_loss(probs, gate_idx, cfg: ModelConfig):
    """Switch aux loss: E · Σ_e (mean prob_e · top-1 fraction_e) · the
    aux weight, over every row of ``probs`` (..., E)."""
    E = cfg.n_experts
    me = probs.reshape(-1, E).mean(0)
    ce = F.one_hot(gate_idx[..., 0].reshape(-1), E).float().mean(0)
    return E * torch.sum(me * ce) * cfg.router_aux_weight


def _expert_ffn(xin, w_in, w_gate, w_out):
    if is_dtensor(xin):
        # expert parallel: each rank's groups (data axes) through its
        # experts (model), the reference's layout of xin and eo
        b, m = split_axes(xin, xin.shape[0], xin.shape[1])
        return per_shard(_expert_ffn, (xin, w_in, w_gate, w_out),
                         (P(b, m), P(m), P(m), P(m)), (P(b, m),))
    h = torch.einsum("necd,edf->necf", xin, w_in)
    g = torch.einsum("necd,edf->necf", xin, w_gate)
    return torch.einsum("necf,efd->necd", F.silu(g) * h, w_out)


def apply_moe(moe: MoE, x, cfg: ModelConfig):
    """x: (B, S, D) -> (y, aux) (``moe.py:39-107``)."""
    B, S, D = x.shape
    E, K, G = cfg.n_experts, cfg.top_k, cfg.moe_group_size
    T = B * S
    n = -(-T // G)
    xg = F.pad(x.reshape(T, D), (0, 0, 0, n * G - T)).reshape(n, G, D)
    xg = constrain(xg, "batch", None, None)
    probs, gate_vals, gate_idx = route(xg, moe.router, K)     # (n, G, K)

    cap = max(1, int(G * K * cfg.capacity_factor / E))
    # slot of each (token, k) among its expert's: an exclusive cumsum in
    # token-major, k-minor order
    onehot = F.one_hot(gate_idx, E)                           # (n,G,K,E)
    flat = onehot.reshape(n, G * K, E)
    slot = ((flat.cumsum(1) - flat) * flat).sum(-1).reshape(n, G, K)
    keep = slot < cap
    oh_e = onehot.to(x.dtype)
    oh_c = F.one_hot(torch.where(keep, slot, cap),
                     cap + 1).to(x.dtype)[..., :cap]          # (n,G,K,cap)
    # each (g, e, c) holds at most one k: these sums are exact
    disp = torch.einsum("ngke,ngkc->ngec", oh_e, oh_c)
    comb = torch.einsum("ngke,ngkc->ngec",
                        oh_e * gate_vals.to(x.dtype)[..., None], oh_c)

    xin = torch.einsum("ngec,ngd->necd", disp, xg)            # (n,E,cap,D)
    xin = constrain(xin, "batch", "experts", None, None)
    weights = (moe.w_in, moe.w_gate, moe.w_out)
    if torch.is_grad_enabled():
        eo = torch.utils.checkpoint.checkpoint(_expert_ffn, xin, *weights,
                                               use_reentrant=False)
    else:
        eo = _expert_ffn(xin, *weights)
    eo = constrain(eo, "batch", "experts", None, None)
    y = torch.einsum("ngec,necd->ngd", comb, eo)              # (n, G, D)
    if hasattr(moe, "shared"):
        y = y + moe.shared(xg)
    y = y.reshape(n * G, D)[:T].reshape(B, S, D)
    return y, load_balance_loss(probs, gate_idx, cfg)
