"""Catch: the classic pixel-control test environment (Atari stand-in).

Counterpart of ``repro/envs/catch.py``. A ball falls from a random column
of a ROWS x COLS board; the paddle on the bottom row moves
left/stay/right. Reward +1 on catch, -1 on miss, episode length
ROWS - 1 steps. Observation: (ROWS, COLS, 1) float image. State leaves
are int32 scalars.
"""
from __future__ import annotations

import torch

from repro_torch.core import determinism
from repro_torch.envs.interfaces import Env, with_autoreset

ROWS, COLS = 10, 5


def _obs(state):
    dev = state["ball_r"].device
    one = torch.ones((), dtype=torch.float32, device=dev)
    board = torch.zeros((ROWS, COLS), dtype=torch.float32, device=dev)
    board = board.index_put((state["ball_r"].long(), state["ball_c"].long()),
                            one)
    row = torch.full((), ROWS - 1, dtype=torch.int64, device=dev)
    board = board.index_put((row, state["paddle"].long()), one)
    return board[..., None]


def _reset(key):
    state = {
        "ball_r": torch.zeros((), dtype=torch.int32, device=key.device),
        "ball_c": determinism.randint(key, (), 0, COLS),
        "paddle": torch.full((), COLS // 2, dtype=torch.int32,
                             device=key.device),
    }
    return state, _obs(state)


def _step(state, action, key):
    move = action.to(torch.int32) - 1       # {0,1,2} -> {-1,0,1}
    paddle = torch.clamp(state["paddle"] + move, 0, COLS - 1)
    ball_r = state["ball_r"] + 1
    ns = {"ball_r": ball_r, "ball_c": state["ball_c"], "paddle": paddle}
    done = ball_r >= ROWS - 1
    caught = paddle == state["ball_c"]
    reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
    return ns, _obs(ns), reward.to(torch.float32), done.to(torch.float32)


def make() -> Env:
    return with_autoreset("catch", _reset, _step, (ROWS, COLS, 1), 3)
