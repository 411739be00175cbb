"""Actor-critic losses: n-step returns, GAE, A2C (paper Eq. 4), PPO-clip
and truncated-IS A2C.

Counterpart of ``repro/core/losses.py``. Trajectories are time-major
``(T, B, ...)``; all loss arithmetic is fp32. The reverse-time scans are
Python loops that build new tensors (no in-place writes), so
``torch.func`` differentiates through them; ``stop_gradient`` is
``detach``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class LossStats(NamedTuple):
    total: torch.Tensor
    pg: torch.Tensor
    value: torch.Tensor
    entropy: torch.Tensor


def _reverse_scan(step, init, xs):
    """``lax.scan(step, init, xs, reverse=True)``'s stacked outputs, for a
    ``step`` whose carry is its output. ``xs``: tensors with time first."""
    acc, outs = init, []
    for t in range(xs[0].shape[0] - 1, -1, -1):
        acc = step(acc, *(x[t] for x in xs))
        outs.append(acc)
    return torch.stack(outs[::-1])


def n_step_returns(rewards, dones, bootstrap_value, gamma: float):
    """rewards/dones: (T, B); bootstrap_value: (B,). Returns (T, B).

    R_t = r_t + gamma * (1 - done_t) * R_{t+1}, R_T seeded by the critic.
    """
    return _reverse_scan(lambda ret, r, d: r + gamma * (1.0 - d) * ret,
                         bootstrap_value.float(),
                         (rewards.float(), dones.float()))


def gae(rewards, dones, values, bootstrap_value, gamma: float,
        lam: float = 0.95):
    """Generalized advantage estimation. values: (T, B). Returns
    (advantages, returns)."""
    values = values.float()
    next_values = torch.cat([values[1:], bootstrap_value[None].float()], 0)
    nd = 1.0 - dones.float()
    deltas = rewards.float() + gamma * nd * next_values - values
    adv = _reverse_scan(lambda acc, delta, mask: delta + gamma * lam * mask
                        * acc,
                        torch.zeros_like(bootstrap_value, dtype=torch.float32),
                        (deltas, nd))
    return adv, adv + values


def take_action(x, actions):
    """x[..., actions] along the last axis, as ``take_along_axis``: the
    one entry kept by a one-hot select (an elementwise backward)."""
    onehot = actions.long()[..., None] == torch.arange(
        x.shape[-1], device=x.device)
    return torch.where(onehot, x, 0.0).sum(-1)


def _entropy(logits):
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(torch.exp(logp) * logp).sum(-1)


def _logprob(logits, actions):
    return take_action(torch.log_softmax(logits.float(), dim=-1), actions)


def _masked_mean(x, m, denom):
    return (x * m).sum() / denom


def a2c_loss(logits, values, actions, advantages, returns,
             value_coef: float = 0.5, entropy_coef: float = 0.01,
             mask=None) -> LossStats:
    """Paper Eq. (4). logits: (..., A); others: (...,). Advantages are
    constants (detached)."""
    adv = advantages.float().detach()
    lp = _logprob(logits, actions)
    ent = _entropy(logits)
    m = torch.ones_like(lp) if mask is None else mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    pg = -_masked_mean(lp * adv, m, denom)
    v = _masked_mean(torch.square(values.float() - returns.float()), m, denom)
    e = _masked_mean(ent, m, denom)
    total = pg + value_coef * v - entropy_coef * e
    return LossStats(total, pg, v, e)


def ppo_loss(logits, values, actions, advantages, returns,
             behavior_logprob, clip_eps: float = 0.2,
             value_coef: float = 0.5, entropy_coef: float = 0.01,
             mask=None) -> LossStats:
    adv = advantages.float().detach()
    mean = adv.mean()
    std = torch.sqrt(torch.square(adv - mean).mean())
    adv = (adv - mean) / (std + 1e-8)
    lp = _logprob(logits, actions)
    ratio = torch.exp(lp - behavior_logprob.float())
    ent = _entropy(logits)
    m = torch.ones_like(lp) if mask is None else mask.float()
    denom = torch.clamp(m.sum(), min=1.0)
    un = ratio * adv
    cl = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv
    pg = -_masked_mean(torch.minimum(un, cl), m, denom)
    v = _masked_mean(torch.square(values.float() - returns.float()), m, denom)
    e = _masked_mean(ent, m, denom)
    total = pg + value_coef * v - entropy_coef * e
    return LossStats(total, pg, v, e)


def truncated_is_a2c_loss(logits, values, actions, advantages, returns,
                          behavior_logprob, rho_max: float = 1.0,
                          value_coef: float = 0.5,
                          entropy_coef: float = 0.01) -> LossStats:
    """Truncated importance-sampling corrected A2C (the Tab. A1 ablation
    alternative to the delayed gradient)."""
    adv = advantages.float().detach()
    lp = _logprob(logits, actions)
    rho = torch.clamp(torch.exp(lp.detach() - behavior_logprob.float()),
                      max=rho_max)
    ent = _entropy(logits)
    pg = -(rho * lp * adv).mean()
    v = torch.square(values.float() - returns.float()).mean()
    e = ent.mean()
    total = pg + value_coef * v - entropy_coef * e
    return LossStats(total, pg, v, e)
