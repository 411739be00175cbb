"""V-trace off-policy correction (Espeholt et al., 2018).

Counterpart of ``repro/core/vtrace.py``; the reverse-time scan is a
Python loop that builds new tensors (``losses._reverse_scan``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.losses import _reverse_scan


class VTraceReturns(NamedTuple):
    vs: torch.Tensor           # (T, B) value targets
    pg_advantages: torch.Tensor


def vtrace(behavior_logprob, target_logprob, rewards, dones, values,
           bootstrap_value, gamma: float, rho_max: float = 1.0,
           c_max: float = 1.0) -> VTraceReturns:
    """All inputs (T, B); bootstrap_value (B,). Standard V-trace targets:

        vs_t = V(x_t) + sum_{i>=t} gamma^{i-t} (prod c) delta_i
        delta_i = rho_i (r_i + gamma V(x_{i+1}) - V(x_i))
    """
    rho = torch.clamp(torch.exp(target_logprob - behavior_logprob),
                      max=rho_max)
    c = torch.clamp(torch.exp(target_logprob - behavior_logprob), max=c_max)
    values = values.float()
    nd = 1.0 - dones.float()
    boot = bootstrap_value[None].float()
    next_values = torch.cat([values[1:], boot], 0)
    deltas = rho * (rewards.float() + gamma * nd * next_values - values)
    dv = _reverse_scan(lambda acc, delta, c_t, mask: delta + gamma * mask
                       * c_t * acc,
                       torch.zeros_like(bootstrap_value, dtype=torch.float32),
                       (deltas, c, nd))
    vs = values + dv
    next_vs = torch.cat([vs[1:], boot], 0)
    pg_adv = rho * (rewards.float() + gamma * nd * next_vs - values)
    return VTraceReturns(vs.detach(), pg_adv.detach())
