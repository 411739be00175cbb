"""Minimal optax-style optimizers on trees of tensors.

Counterpart of ``repro/optim/optimizers.py``, expression for expression
(``torch.optim`` computes other float expressions). Each optimizer is a
pair of pure functions:

    init(params) -> state
    update(grads, state, params) -> (updates, state)

``apply_updates(params, updates)`` adds. These build new tensors and
write none in place, so a stream that still reads the old params or
state is never raced. Optimizer state is fp32.

Each also has ``update_(grads, state, params, out) -> state``: the same
step in place, leaf by leaf, for a caller that donates its state (the
``stream`` runtime, as the reference's step donates it to XLA). The
state's tensors are updated in place with the same operations in the
same order as ``update``, and the new params, ``(p.float() + u).to(
p.dtype)`` as ``apply_updates`` computes them, are written into ``out``
(a tree like ``params``); the same bits as ``update`` then
``apply_updates``. Only one leaf's temporaries are alive at a time, where
``update`` holds tree-wide fp32 copies of the gradient, the moments and
the update beside the old state.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    update_: Optional[Callable] = None


def _zeros_f32(p):
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _leafwise_(step, grads, params, out, *state_trees) -> None:
    """``out[leaf] = (p.float() + step(g.float(), *state leaves)).to(
    p.dtype)`` leaf by leaf; ``step`` updates the state leaves in place and
    returns the update."""
    for g, p, o, *st in zip(tree_leaves(grads), tree_leaves(params),
                            tree_leaves(out),
                            *(tree_leaves(t) for t in state_trees)):
        u = step(g.float(), *st)
        o.copy_(p.float() + u)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    def update_(grads, state, params, out):
        for g, p, o in zip(tree_leaves(grads), tree_leaves(params),
                           tree_leaves(out)):
            o.copy_(p.float() + -lr * g)
        return state

    return Optimizer(init, update, update_)


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

    def step_(g, sq, mom=None):
        sq.mul_(decay).add_((1 - decay) * g * g)
        u = -lr * g / (torch.sqrt(sq) + eps)
        if mom is not None:
            return mom.mul_(momentum).add_(u)
        return u

    def update_(grads, state, params, out):
        _leafwise_(step_, grads, params, out,
                   *((state["sq"], state["mom"]) if momentum
                     else (state["sq"],)))
        return state

    return Optimizer(init, update, update_)


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

    def update_(grads, state, params, out):
        t = state["t"].add_(1)
        tf = t.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=tf.device), tf)

        def step_(g, m_, v_):
            m_.mul_(b1).add_((1 - b1) * g)
            v_.mul_(b2).add_((1 - b2) * g * g)
            return -lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)

        _leafwise_(step_, grads, params, out, state["m"], state["v"])
        return state

    return Optimizer(init, update, update_)


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

    def update_(grads, state, params, out):
        grads, _ = clip_fn(grads)
        return opt.update_(grads, state, params, out)

    return Optimizer(opt.init, update,
                     update_ if opt.update_ is not None else None)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)
