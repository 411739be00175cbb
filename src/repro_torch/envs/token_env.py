"""Token environment: next-token prediction as an MDP, so the sequence
backbones are policies trained by the HTS-RL learner.

Counterpart of ``repro/envs/token_env.py``. A hidden deterministic
transition table T: V -> V (a permutation, ``determinism.permutation`` of
jax's key ``seed * 7 + 1``, made lossy: every 17th token maps where token
0 does) generates a token stream. The observation is the current token
(an int32 scalar); the action a vocabulary token; reward 1 when the
action is the true next token. Episodes last ``HORIZON`` steps.
"""
from __future__ import annotations

import torch

from repro_torch.core import determinism
from repro_torch.envs.interfaces import Env, with_autoreset

HORIZON = 64


def make(vocab: int = 256, seed: int = 0) -> Env:
    table = determinism.permutation(determinism.master_key(seed * 7 + 1),
                                    vocab)
    lossy = torch.arange(vocab) % 17 == 0
    table = torch.where(lossy, table[0], table)
    tables = {}

    def _table(device):
        if device not in tables:
            tables[device] = table.to(device)
        return tables[device]

    def _reset(key):
        state = {"tok": determinism.randint(key, (), 0, vocab),
                 "t": torch.zeros((), dtype=torch.int32, device=key.device)}
        return state, state["tok"]

    def _step(state, action, key):
        nxt = _table(key.device)[state["tok"].long()]
        reward = (action == nxt).to(torch.float32)
        t = state["t"] + 1
        ns = {"tok": nxt, "t": t}
        done = (t >= HORIZON).to(torch.float32)
        return ns, nxt, reward, done

    return with_autoreset(f"token{vocab}", _reset, _step, (), vocab)
