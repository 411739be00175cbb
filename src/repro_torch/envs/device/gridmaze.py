"""Device-resident gridmaze: the batched port of ``envs.gridmaze``.

Counterpart of ``repro/envs/device/gridmaze.py``. State: ``{"r", "c",
"t"}``, each an (n,) int32 tensor, the stacked tree the vmapped host env
makes. Moves are a gather from the MOVES table, wall collisions a
batched lookup into the walls board, and the observation is built from
one-hot comparison masks and broadcast copies of the static walls and
goal planes: no scatter. ``make(scenario_seed=k)`` resolves the same
``sample_scenario(k)`` board as the host env.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.envs.device import DeviceEnv, device_autoreset
from repro_torch.envs.gridmaze import HORIZON, N, BoardTensors, resolve_board


def _batched_fns(walls: torch.Tensor, goal):
    gr, gc = goal
    board = BoardTensors(walls, goal)

    def obs(state):
        walls_d, goal_d, _ = board.on(state["r"].device)
        ar = torch.arange(N, dtype=torch.int32, device=walls_d.device)
        rows = (state["r"][:, None] == ar).to(torch.float32)
        cols = (state["c"][:, None] == ar).to(torch.float32)
        agent = rows[:, :, None] * cols[:, None, :]
        n = state["r"].shape[0]
        return torch.stack([walls_d.expand(n, N, N), agent,
                            goal_d.expand(n, N, N)], dim=-1)

    def reset(keys):
        def zeros():
            return torch.zeros((keys.shape[0],), dtype=torch.int32,
                               device=keys.device)
        state = {"r": zeros(), "c": zeros(), "t": zeros()}
        return state, obs(state)

    def step(state, actions, keys):
        del keys                                # transitions are deterministic
        walls_d, _, moves = board.on(state["r"].device)
        mv = moves[actions.long()]              # (n, 2) gather
        nr = torch.clamp(state["r"] + mv[:, 0], 0, N - 1)
        nc = torch.clamp(state["c"] + mv[:, 1], 0, N - 1)
        blocked = walls_d[nr.long(), nc.long()] > 0
        nr = torch.where(blocked, state["r"], nr)
        nc = torch.where(blocked, state["c"], nc)
        t = state["t"] + 1
        at_goal = (nr == gr) & (nc == gc)
        done = at_goal | (t >= HORIZON)
        reward = torch.where(at_goal, 1.0, -0.01).to(torch.float32)
        ns = {"r": nr, "c": nc, "t": t}
        return ns, obs(ns), reward, done.to(torch.float32)

    return reset, step


def make(scenario_seed: Optional[int] = None) -> DeviceEnv:
    walls, goal = resolve_board(scenario_seed)
    reset, step = _batched_fns(walls, goal)
    return device_autoreset("gridmaze@device", reset, step, (N, N, 3), 4,
                            host_name="gridmaze")
