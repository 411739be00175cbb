"""PPO-clip against the executor-recorded ``behavior_logprob``.
Counterpart of ``repro/algorithms/ppo.py``: one update per interval, the
ratio is 1 at the delayed gradient's differentiation point."""
from __future__ import annotations

from repro_torch.algorithms import base
from repro_torch.core import losses


class PPO:
    name = "ppo"

    def loss(self, policy_apply, params, traj, cfg):
        logits, values, bv = base.policy_on_traj(policy_apply, params, traj)
        adv, rets = base.advantages_and_returns(values, bv, traj, cfg)
        st = losses.ppo_loss(logits, values, traj["actions"], adv, rets,
                             traj["behavior_logprob"], cfg.ppo_clip,
                             cfg.value_coef, cfg.entropy_coef)
        return st.total, st


base.register(PPO())
