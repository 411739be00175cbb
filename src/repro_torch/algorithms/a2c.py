"""A2C (paper Eq. 4): n-step returns, or GAE when ``cfg.use_gae``.
Counterpart of ``repro/algorithms/a2c.py``."""
from __future__ import annotations

from repro_torch.algorithms import base
from repro_torch.core import losses


class A2C:
    name = "a2c"

    def loss(self, policy_apply, params, traj, cfg):
        logits, values, bv = base.policy_on_traj(policy_apply, params, traj)
        adv, rets = base.advantages_and_returns(values, bv, traj, cfg)
        st = losses.a2c_loss(logits, values, traj["actions"], adv, rets,
                             cfg.value_coef, cfg.entropy_coef)
        return st.total, st


base.register(A2C())
