"""Rollout -> learner-batch pipeline.

Counterpart of ``repro/data/pipeline.py``. Two producers feed the LLM
learner:

* ``traj_to_batch``: an (alpha, n_envs) trajectory from the rollout as
  the flat (B, S) token batch the learner consumes (envs as batch, time
  as sequence), advantages and returns computed on the behavior values;
* ``TokenStream``: a deterministic synthetic token source (the hidden
  Markov chain of ``envs/token_env``, batched), a pure function of
  (seed, step), so ``skip`` fast-forwards and a resumed run sees the
  stream it stopped in.

Bit-exact with the reference: the transition table is
``determinism.permutation`` of jax's key ``seed * 7 + 1``, a batch's
start tokens ``determinism.randint`` under ``fold_in(key(seed), step)``.
Tensors are made on ``device`` (the CPU unless given).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import determinism, losses


def traj_to_batch(traj: Dict, values, bootstrap_value, gamma: float = 0.99,
                  lam: float = 0.95, use_gae: bool = True) -> Dict:
    """traj: {obs/actions/rewards/dones/behavior_logprob (T, N, ...)} ->
    learner batch with (N, T) layout."""
    if use_gae:
        adv, rets = losses.gae(traj["rewards"], traj["dones"], values,
                               bootstrap_value, gamma, lam)
    else:
        rets = losses.n_step_returns(traj["rewards"], traj["dones"],
                                     bootstrap_value, gamma)
        adv = rets - values

    def tn(x):
        return x.transpose(0, 1)

    return {
        "tokens": tn(traj["obs"]).to(torch.int32),
        "actions": tn(traj["actions"]).to(torch.int32),
        "advantages": tn(adv),
        "returns": tn(rets),
        "behavior_logprob": tn(traj["behavior_logprob"]),
        "loss_mask": torch.ones_like(tn(adv)),
    }


class TokenStream:
    """Deterministic batched token stream (B, S) over a hidden Markov
    transition table; next-token targets become RL actions (the
    token_env contract, vectorized)."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 device=None):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.device = torch.device("cpu" if device is None else device)
        self.table = determinism.permutation(
            determinism.master_key(seed * 7 + 1, self.device), vocab).long()
        self._step = 0
        self.key = determinism.master_key(seed, self.device)

    def skip(self, n: int) -> "TokenStream":
        """Fast-forward past ``n`` batches without generating them."""
        self._step += n
        return self

    def next_batch(self) -> Dict:
        key = determinism.fold_in(self.key, self._step)
        self._step += 1
        tok = determinism.randint(key, (self.batch,), 0, self.vocab).long()
        toks = [tok]
        for _ in range(self.seq):
            tok = self.table[tok]
            toks.append(tok)
        toks = torch.stack(toks, dim=1).to(torch.int32)   # (B, S+1)
        tokens, targets = toks[:, :-1], toks[:, 1:]
        shape, dev = tokens.shape, self.device
        return {
            "tokens": tokens,
            "actions": targets,
            "advantages": torch.ones(shape, device=dev),
            "returns": torch.ones(shape, device=dev),
            "behavior_logprob": torch.full(shape, -1.0, device=dev),
            "loss_mask": torch.ones(shape, device=dev),
        }
