"""Dropless MoE: every token routed, no capacity.

Counterpart of ``repro/models/moe_dropless.py`` (``_dropless_local``,
``apply_moe_dropless``), selected by ``cfg.moe_impl == "dropless"``. The
steps are the reference's: top-k with its tie-break (``moe.route``); a
stable sort of the flattened expert ids; the tokens gathered in that
order; the group sizes by ``bincount``; one product per expert over its
slice of rows (the counterpart of ``jax.lax.ragged_dot``); the inverse
permutation; the gates combined in fp32; the aux loss.

The group sizes cut the rows on the host, so each MoE layer makes one
device-to-host copy of E integers (a synchronization on the card). A
``FakeTensor`` (the dry run) has no values to count: it takes equal
group sizes, which give the same products' total rows, so the same
FLOPs and bytes, as any routing.

With a mesh active and a ``DTensor`` input, the tokens are routed per
data shard, as the reference does under ``shard_map``: ``local_map``
runs the local function on each shard of the (B*S, D) tokens over the
data axes, the expert weights replicated, and ``aux`` comes out as a
``Partial("avg")`` over the data axes, which averages it as ``pmean``
does. Without a mesh the plain local branch runs, as in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import is_dtensor, is_fake
from repro_torch.launch.mesh import active_mesh, axis_sizes
from repro_torch.models import moe


def _grouped(x, w, sizes: list):
    """Rows of ``x`` in consecutive groups of ``sizes``, group e times
    ``w[e]``: ``ragged_dot(x, w, sizes)``."""
    return torch.cat([part @ w[e]
                      for e, part in enumerate(torch.split(x, sizes))])


def _group_sizes(flat_expert, E: int) -> list:
    if is_fake(flat_expert):
        n = flat_expert.numel()
        return [n // E + (e < n % E) for e in range(E)]
    return torch.bincount(flat_expert, minlength=E).tolist()


def _dropless_local(xt, router, w_in, w_gate, w_out, cfg: ModelConfig):
    """One shard's tokens (T, D) through all experts -> (y (T, D), aux)."""
    T, D = xt.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, gate_vals, gate_idx = moe.route(xt, router, K)       # (T, K)

    flat_expert = gate_idx.reshape(-1)
    flat_token = torch.arange(T, device=xt.device).repeat_interleave(K)
    order = torch.sort(flat_expert, stable=True).indices
    xs = xt[flat_token[order]]                                # (T*K, D)
    sizes = _group_sizes(flat_expert, E)

    h = _grouped(xs, w_in, sizes)
    h = F.silu(_grouped(xs, w_gate, sizes)) * h
    eo = _grouped(h, w_out, sizes)                            # (T*K, D)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=xt.device)
    eo = eo[inv].reshape(T, K, D)
    y = torch.einsum("tkd,tk->td", eo.float(), gate_vals).to(xt.dtype)
    return y, moe.load_balance_loss(probs, gate_idx, cfg)


def _per_data_shard(mesh, xt, weights, cfg: ModelConfig):
    """The ``shard_map`` branch through ``local_map``, or None when the
    mesh has no data axis that divides the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    sizes = axis_sizes(mesh)
    data = [a for a in ("pod", "data") if a in sizes]
    if not data or xt.shape[0] % math.prod(sizes[a] for a in data):
        return None
    names = mesh.mesh_dim_names
    tok = tuple(Shard(0) if a in data else Replicate() for a in names)
    rep = tuple(Replicate() for _ in names)
    aux = tuple(Partial("avg") if a in data else Replicate() for a in names)
    fn = local_map(lambda x_, *w: _dropless_local(x_, *w, cfg),
                   out_placements=(tok, aux),
                   in_placements=(tok,) + (rep,) * len(weights),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(xt, *weights)


def apply_moe_dropless(ffn: moe.MoE, x, cfg: ModelConfig):
    """x: (B, S, D) -> (y, aux)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    weights = (ffn.router, ffn.w_in, ffn.w_gate, ffn.w_out)
    mesh = active_mesh()
    out = (_per_data_shard(mesh, xt, weights, cfg)
           if mesh is not None and is_dtensor(xt) else None)
    y, aux = out if out is not None else _dropless_local(xt, *weights, cfg)
    y = y.reshape(B, S, D)
    if hasattr(ffn, "shared"):
        y = y + ffn.shared(x)
    return y, aux
