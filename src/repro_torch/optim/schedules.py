"""Learning-rate schedules (pure functions step -> lr multiplier).
Counterpart of ``repro/optim/schedules.py``; each returns an fp32 0-d
tensor on ``step``'s device (the CPU for a Python int)."""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.optim.optimizers import Optimizer


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float) -> Callable:
    return lambda step: torch.full((), lr, dtype=torch.float32)


def linear_decay(lr: float, total_steps: int, floor: float = 0.0) -> Callable:
    def f(step):
        frac = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return lr * (1.0 - frac) + floor * frac
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  floor_ratio: float = 0.1) -> Callable:
    def f(step):
        step = _f32(step)
        warm = lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * (floor_ratio + (1 - floor_ratio)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)
    return f


def scheduled(opt_factory: Callable, schedule: Callable):
    """Wrap an optimizer factory (lr -> Optimizer) with a schedule: the
    state carries a step counter and the lr is re-derived each update."""
    base = opt_factory(1.0)     # unit-lr optimizer; scale updates

    def init(params):
        dev = tree_leaves(params)[0].device
        return {"inner": base.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None):
        upd, inner = base.update(grads, state["inner"], params)
        lr = schedule(state["step"])
        upd = tree_map(lambda u: u * lr, upd)
        return upd, {"inner": inner, "step": state["step"] + 1}

    return Optimizer(init, update)
