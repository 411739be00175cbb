"""The one traffic generator: learner batches of packed RL episodes, read
from a traffic file's parameters and drawn from the run's seed.

A traffic file (``bench/traffic/<mix>.json``) gives ``batch`` rows of
``seq`` tokens. Each row packs whole episodes first-fit; episode lengths
are lognormal (``episode_median``, ``episode_sigma``), capped at ``seq``;
what a row cannot take is padding with ``loss_mask`` 0. An episode that
fits no row of a batch opens the next batch; a batch closes after
``close_after`` such misses in a row. Tokens are uniform over the
vocabulary; the action at a position is the next token. Each token
earns a reward N(0, ``step_reward_std``), and an episode's last token
also N(0, 1); returns are the discounted (``gamma``) sums to the
episode's end, advantages the returns less the episode's mean return.
Behaviour log-probs are -log(vocab) + N(0, ``logprob_std``).

``pool`` batches are drawn, all in numpy from the seed (so the CPU and
the card see the same batches), and placed on the device in set-up; a
run longer than the pool cycles it.
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from repro_torch.data.pipeline import TokenStream

FIELDS = ("tokens", "actions", "advantages", "returns", "behavior_logprob",
          "loss_mask")


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), 0x7261])


def _layouts(p: dict, rng) -> List[List[List[int]]]:
    """For each of the pool's batches, each row's episode lengths."""
    B, S = p["batch"], p["seq"]
    mu, sigma = math.log(p["episode_median"]), p["episode_sigma"]
    carry: List[int] = []
    out = []
    for _ in range(p["pool"]):
        rows: List[List[int]] = [[] for _ in range(B)]
        free = [S] * B
        misses = 0
        while misses < p["close_after"]:
            if carry:
                n = carry.pop(0)
            else:
                n = int(min(S, max(1, round(rng.lognormal(mu, sigma)))))
            for i in range(B):
                if free[i] >= n:
                    rows[i].append(n)
                    free[i] -= n
                    misses = 0
                    break
            else:
                carry.append(n)
                misses += 1
        out.append(rows)
    return out


def batches(p: dict, vocab: int, seed: int) -> List[Dict[str, np.ndarray]]:
    """The pool's batches as numpy arrays: a pure function of (the traffic
    parameters, vocab, seed)."""
    rng = _rng(seed)
    B, S, P = p["batch"], p["seq"], p["pool"]
    layouts = _layouts(p, rng)
    toks = rng.integers(0, vocab, size=(P, B, S + 1), dtype=np.int64)
    step_r = rng.normal(0.0, p["step_reward_std"], size=(P, B, S))
    final_r = rng.normal(0.0, 1.0, size=(P, B, S))
    blp = -math.log(vocab) + rng.normal(0.0, p["logprob_std"],
                                        size=(P, B, S))
    # per position: its episode's id (-1 on padding) and whether it ends it
    episode = np.full((P, B, S), -1, dtype=np.int64)
    last = np.zeros((P, B, S), dtype=bool)
    eid = 0
    for b, rows in enumerate(layouts):
        for r, lengths in enumerate(rows):
            t = 0
            for n in lengths:
                episode[b, r, t:t + n] = eid
                last[b, r, t + n - 1] = True
                eid += 1
                t += n
    mask = episode >= 0
    rewards = np.where(mask, step_r + np.where(last, final_r, 0.0), 0.0)
    # discounted returns to each episode's end, all rows at once
    returns = np.zeros((P, B, S))
    g = np.zeros((P, B))
    for t in reversed(range(S)):
        g = np.where(last[..., t], 0.0, g)
        g = rewards[..., t] + p["gamma"] * g
        returns[..., t] = g
    returns = np.where(mask, returns, 0.0)
    # each episode's mean return as its baseline
    flat_ep = episode[mask]
    mean = (np.bincount(flat_ep, weights=returns[mask], minlength=eid)
            / np.maximum(np.bincount(flat_ep, minlength=eid), 1))
    adv = np.zeros_like(returns)
    adv[mask] = returns[mask] - mean[flat_ep]
    out = []
    for i in range(P):
        out.append({
            "tokens": toks[i, :, :-1].astype(np.int32),
            "actions": toks[i, :, 1:].astype(np.int32),
            "advantages": adv[i].astype(np.float32),
            "returns": returns[i].astype(np.float32),
            "behavior_logprob": blp[i].astype(np.float32),
            "loss_mask": mask[i].astype(np.float32),
        })
    return out


def on_device(pool, device) -> List[Dict[str, torch.Tensor]]:
    return [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
            for b in pool]


class PoolStream(TokenStream):
    """The stream runtime's workload: a ``TokenStream`` that hands out the
    pool's batches, already on the device, in order and then again."""

    def __init__(self, pool: List[Dict[str, torch.Tensor]], vocab: int,
                 batch: int, seq: int):
        # TokenStream's own table and key are not used
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.pool = pool
        self._step = 0
        self.served: List[int] = []     # the pool's index of each batch

    def next_batch(self) -> Dict[str, torch.Tensor]:
        i = self._step % len(self.pool)
        self._step += 1
        self.served.append(i)
        return dict(self.pool[i])
