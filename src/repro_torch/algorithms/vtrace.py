"""Stale-policy corrections (paper Eq. 5 and Sec. 2) as Algorithms.

Counterpart of ``repro/algorithms/vtrace.py``. A2C on off-policy data
with one correction mode each: ``none``, ``epsilon`` (GA3C's
pi(a|s) + eps inside the log), ``trunc_is`` (truncated importance
sampling) and ``vtrace`` (IMPALA's targets, ``core/vtrace.py``).
Registered: ``vtrace``, ``epsilon`` and ``trunc_is``; ``make_correction``
builds any mode from an ``AsyncConfig`` for the async baseline.
"""
from __future__ import annotations

import torch

from repro_torch.algorithms import base
from repro_torch.core import losses
from repro_torch.core import vtrace as vtrace_mod

CORRECTIONS = ("none", "epsilon", "trunc_is", "vtrace")


class StaleCorrected:
    """A2C on off-policy data with a configurable correction mode."""

    def __init__(self, correction: str = "vtrace", *, epsilon: float = 1e-3,
                 rho_max: float = 1.0, name: str | None = None):
        if correction not in CORRECTIONS:
            raise ValueError(f"unknown correction {correction!r}; "
                             f"choose from {CORRECTIONS}")
        self.correction = correction
        self.epsilon = epsilon
        self.rho_max = rho_max
        self.name = name if name is not None else correction

    def loss(self, policy_apply, params, traj, cfg):
        logits, values, bv = base.policy_on_traj(policy_apply, params, traj)

        if self.correction == "vtrace":
            logp = torch.log_softmax(logits.float(), dim=-1)
            tlp = losses.take_action(logp, traj["actions"])
            vt = vtrace_mod.vtrace(traj["behavior_logprob"], tlp.detach(),
                                   traj["rewards"], traj["dones"],
                                   values.detach(), bv, cfg.gamma,
                                   self.rho_max)
            ent = -(torch.exp(logp) * logp).sum(-1)
            pg = -(tlp * vt.pg_advantages).mean()
            vl = torch.square(values - vt.vs).mean()
            e = ent.mean()
            total = pg + cfg.value_coef * vl - cfg.entropy_coef * e
            return total, losses.LossStats(total, pg, vl, e)

        rets = losses.n_step_returns(traj["rewards"], traj["dones"], bv,
                                     cfg.gamma)
        adv = rets - values.detach()
        if self.correction == "trunc_is":
            st = losses.truncated_is_a2c_loss(
                logits, values, traj["actions"], adv, rets,
                traj["behavior_logprob"], self.rho_max,
                cfg.value_coef, cfg.entropy_coef)
            return st.total, st
        if self.correction == "epsilon":
            logp = torch.log_softmax(logits.float(), dim=-1)
            p_a = torch.exp(losses.take_action(logp, traj["actions"]))
            lp = torch.log(p_a + self.epsilon)
            ent = -(torch.exp(logp) * logp).sum(-1)
            pg = -(lp * adv.detach()).mean()
            vl = torch.square(values - rets).mean()
            e = ent.mean()
            total = pg + cfg.value_coef * vl - cfg.entropy_coef * e
            return total, losses.LossStats(total, pg, vl, e)
        st = losses.a2c_loss(logits, values, traj["actions"], adv, rets,
                             cfg.value_coef, cfg.entropy_coef)
        return st.total, st


def make_correction(acfg) -> StaleCorrected:
    """Instance from an AsyncConfig-shaped object (correction, epsilon,
    rho_max)."""
    return StaleCorrected(acfg.correction, epsilon=acfg.epsilon,
                          rho_max=acfg.rho_max)


base.register(StaleCorrected("vtrace"))
base.register(StaleCorrected("epsilon"))
base.register(StaleCorrected("trunc_is"))
