"""Device-resident catch: the batched port of ``envs.catch``.

Counterpart of ``repro/envs/device/catch.py``. State: ``{"ball_r",
"ball_c", "paddle"}``, each an (n,) int32 tensor, the stacked tree the
vmapped host env makes. The board is built from broadcast comparisons
(no scatter); ``maximum`` gives the value of the host env's two writes
where they land on one cell. The reset column is the host env's own
``randint``, drawn for every key at once.
"""
from __future__ import annotations

import torch

from repro_torch.core import determinism
from repro_torch.envs.catch import COLS, ROWS
from repro_torch.envs.device import DeviceEnv, device_autoreset


def _one_hot(idx, size: int):
    ar = torch.arange(size, dtype=torch.int32, device=idx.device)
    return (idx[:, None] == ar).to(torch.float32)


def _obs(state):
    ball = (_one_hot(state["ball_r"], ROWS)[:, :, None]
            * _one_hot(state["ball_c"], COLS)[:, None, :])
    bottom_row = (torch.arange(ROWS, dtype=torch.int32,
                               device=ball.device) == ROWS - 1)
    paddle = (bottom_row.to(torch.float32)[None, :, None]
              * _one_hot(state["paddle"], COLS)[:, None, :])
    return torch.maximum(ball, paddle)[..., None]


def _reset(keys):
    n = keys.shape[0]
    state = {
        "ball_r": torch.zeros((n,), dtype=torch.int32, device=keys.device),
        "ball_c": determinism.randint(keys, (), 0, COLS),
        "paddle": torch.full((n,), COLS // 2, dtype=torch.int32,
                             device=keys.device),
    }
    return state, _obs(state)


def _step(state, actions, keys):
    del keys                                # transitions are deterministic
    move = actions.to(torch.int32) - 1      # {0,1,2} -> {-1,0,1}
    paddle = torch.clamp(state["paddle"] + move, 0, COLS - 1)
    ball_r = state["ball_r"] + 1
    ns = {"ball_r": ball_r, "ball_c": state["ball_c"], "paddle": paddle}
    done = ball_r >= ROWS - 1
    caught = paddle == state["ball_c"]
    reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
    return ns, _obs(ns), reward.to(torch.float32), done.to(torch.float32)


def make() -> DeviceEnv:
    return device_autoreset("catch@device", _reset, _step, (ROWS, COLS, 1),
                            3, host_name="catch")
