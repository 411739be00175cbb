"""Minimal optax-style optimizers on trees of tensors.

Counterpart of ``repro/optim/optimizers.py``, expression for expression
(``torch.optim`` computes other float expressions). Each optimizer is a
pair of pure functions:

    init(params) -> state
    update(grads, state, params) -> (updates, state)

``apply_updates(params, updates)`` adds. Every function builds new
tensors and writes none in place, so a stream that still reads the old
params or state is never raced. Optimizer state is fp32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def rmsprop(lr: float, decay: float = 0.99, eps: float = 1e-5,
            momentum: float = 0.0) -> Optimizer:
    """RMSProp as used by the paper (Kostrikov A2C / TorchBeast IMPALA)."""

    def init(params):
        sq = tree_map(_zeros_f32, params)
        if momentum:
            return {"sq": sq, "mom": tree_map(_zeros_f32, params)}
        return {"sq": sq}

    def update(grads, state, params=None):
        gf = tree_map(lambda g: g.float(), grads)
        sq = tree_map(lambda s, g: decay * s + (1 - decay) * g * g,
                      state["sq"], gf)
        upd = tree_map(lambda g, s: -lr * g / (torch.sqrt(s) + eps), gf, sq)
        new = {"sq": sq}
        if momentum:
            mom = tree_map(lambda m, u: momentum * m + u, state["mom"], upd)
            upd = mom
            new["mom"] = mom
        return upd, new

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"m": tree_map(_zeros_f32, params),
                "v": tree_map(_zeros_f32, params),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        gf = tree_map(lambda g: g.float(), grads)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], gf)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], gf)
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)
        upd = tree_map(lambda m_, v_: -lr * (m_ / bc1)
                       / (torch.sqrt(v_ / bc2) + eps), m, v)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def clip_by_global_norm(max_norm: float) -> Callable:
    """Gradient transform applied before an optimizer: returns (clipped
    grads, global norm). Squares are summed leaf by leaf in
    ``jax.tree_util`` order, as the reference sums them."""

    def clip(grads):
        total = 0
        for g in tree_leaves(grads):
            total = total + torch.sum(torch.square(g.float()))
        gn = torch.sqrt(total)
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return tree_map(lambda g: g * scale.to(g.dtype), grads), gn

    return clip


def chain(clip_fn: Callable, opt: Optimizer) -> Optimizer:
    def update(grads, state, params=None):
        grads, _ = clip_fn(grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)
