"""Dropless MoE: every token routed, no capacity.

Counterpart of ``repro/models/moe_dropless.py`` (``_dropless_local``,
``apply_moe_dropless``), selected by ``cfg.moe_impl == "dropless"``. The
steps are the reference's: top-k with its tie-break (``moe.route``); a
stable sort of the flattened expert ids; the tokens gathered in that
order; the group sizes by ``bincount``; one product per expert over its
slice of rows (the counterpart of ``jax.lax.ragged_dot``); the inverse
permutation; the gates combined in fp32; the aux loss.

The group sizes cut the rows on the host, so each MoE layer makes one
device-to-host copy of E integers (a synchronization on the card).

The reference runs this under ``shard_map`` per data shard when a mesh is
active; that branch is not ported. The port's LLM runtime is one process
(``StreamRuntime``, ``mesh="host"``), where the reference takes its plain
local branch too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe


def _grouped(x, w, sizes: list):
    """Rows of ``x`` in consecutive groups of ``sizes``, group e times
    ``w[e]``: ``ragged_dot(x, w, sizes)``."""
    return torch.cat([part @ w[e]
                      for e, part in enumerate(torch.split(x, sizes))])


def apply_moe_dropless(ffn: moe.MoE, x, cfg: ModelConfig):
    """x: (B, S, D) -> (y, aux)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, gate_vals, gate_idx = moe.route(xt, ffn.router, K)  # (T, K)

    flat_expert = gate_idx.reshape(-1)
    flat_token = torch.arange(T, device=x.device).repeat_interleave(K)
    order = torch.sort(flat_expert, stable=True).indices
    xs = xt[flat_token[order]]                                # (T*K, D)
    sizes = torch.bincount(flat_expert, minlength=E).tolist()

    h = _grouped(xs, ffn.w_in, sizes)
    h = F.silu(_grouped(xs, ffn.w_gate, sizes)) * h
    eo = _grouped(h, ffn.w_out, sizes)                        # (T*K, D)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=x.device)
    eo = eo[inv].reshape(T, K, D)
    y = torch.einsum("tkd,tk->td", eo.float(), gate_vals).to(x.dtype)
    aux = moe.load_balance_loss(probs, gate_idx, cfg)

    y = y.reshape(B, S, D)
    if hasattr(ffn, "shared"):
        y = y + ffn.shared(x)
    return y, aux
