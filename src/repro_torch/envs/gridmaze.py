"""GridMaze: deterministic navigation with pixel observations.

Counterpart of ``repro/envs/gridmaze.py``. An N x N grid with walls; the
agent starts top-left and moves up/down/left/right. Reward +1 at the
goal, -0.01 per step; horizon 4 * N. Observation: an (N, N, 3) float
image (walls, agent, goal). State leaves are int32 scalars ``r``, ``c``,
``t``. Neither reset nor step reads its key.

Two boards: ``scenario_seed=None``, the fixed legacy board (``WALLS``,
goal bottom-right); ``scenario_seed=k``, the board ``sample_scenario(k)``
draws, a pure numpy function of the seed that the device port shares,
copied from the reference so both packages draw the same boards.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.envs.interfaces import Env, with_autoreset

N = 9
HORIZON = 4 * N


def _walls() -> torch.Tensor:
    w = torch.zeros((N, N), dtype=torch.float32)
    w[2, 1:N - 2] = 1.0
    w[5, 2:N] = 1.0
    w[7, 1:4] = 1.0
    return w


WALLS = _walls()
MOVES = torch.tensor([[-1, 0], [1, 0], [0, -1], [0, 1]], dtype=torch.int32)


def _bfs_dist(walls: np.ndarray) -> np.ndarray:
    """Grid distances from (0, 0) through open cells; -1 = unreachable."""
    dist = np.full((N, N), -1, np.int32)
    if walls[0, 0] > 0:
        return dist
    dist[0, 0] = 0
    frontier = [(0, 0)]
    while frontier:
        nxt = []
        for r, c in frontier:
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < N and 0 <= cc < N and walls[rr, cc] == 0 \
                        and dist[rr, cc] < 0:
                    dist[rr, cc] = dist[r, c] + 1
                    nxt.append((rr, cc))
        frontier = nxt
    return dist


def sample_scenario(seed: int) -> Tuple[np.ndarray, Tuple[int, int]]:
    """A solvable (walls, goal) board as a pure function of the seed:
    rejection-samples wall layouts until the farthest BFS-reachable cell
    is at least N steps from the start; the goal is that cell, row-major
    tie-break via argmax."""
    rng = np.random.default_rng(int(seed))
    while True:
        walls = np.zeros((N, N), np.float32)
        for _ in range(3 + int(rng.integers(0, 3))):   # 3..5 segments
            horiz = bool(rng.integers(0, 2))
            r = int(rng.integers(1, N - 1))
            c = int(rng.integers(1, N - 1))
            length = int(rng.integers(3, N - 1))
            if horiz:
                walls[r, c:min(c + length, N)] = 1.0
            else:
                walls[r:min(r + length, N), c] = 1.0
        walls[0, 0] = 0.0
        dist = _bfs_dist(walls)
        dist[0, 0] = -1                    # the start is never the goal
        if dist.max() < N:
            continue                       # too shallow/unsolvable: reject
        goal = np.unravel_index(int(dist.argmax()), dist.shape)
        return walls, (int(goal[0]), int(goal[1]))


def resolve_board(scenario_seed: Optional[int]):
    """(walls (N, N) float32 tensor, goal) for a scenario seed; None = the
    legacy board."""
    if scenario_seed is None:
        return WALLS, (N - 1, N - 1)
    walls, goal = sample_scenario(scenario_seed)
    return torch.from_numpy(walls), goal


def goal_plane(goal: Tuple[int, int]) -> torch.Tensor:
    plane = torch.zeros((N, N), dtype=torch.float32)
    plane[goal] = 1.0
    return plane


class BoardTensors:
    """The static board (walls, goal plane, moves) per device, copied to
    a device once, on first use there."""

    def __init__(self, walls: torch.Tensor, goal: Tuple[int, int]):
        self._cpu = (walls, goal_plane(goal), MOVES)
        self._by_device = {}

    def on(self, device: torch.device):
        if device not in self._by_device:
            self._by_device[device] = tuple(t.to(device) for t in self._cpu)
        return self._by_device[device]


def _scalar_fns(walls: torch.Tensor, goal: Tuple[int, int]):
    """The scalar reset/step pair over one (walls, goal) board."""
    gr, gc = goal
    board = BoardTensors(walls, goal)

    def obs(state):
        walls_d, goal_d, _ = board.on(state["r"].device)
        agent = torch.zeros((N, N), dtype=torch.float32,
                            device=walls_d.device).index_put(
            (state["r"].long(), state["c"].long()),
            torch.ones((), dtype=torch.float32, device=walls_d.device))
        return torch.stack([walls_d, agent, goal_d], dim=-1)

    def reset(key):
        def zero():
            return torch.zeros((), dtype=torch.int32, device=key.device)
        state = {"r": zero(), "c": zero(), "t": zero()}
        return state, obs(state)

    def step(state, action, key):
        del key
        walls_d, _, moves = board.on(state["r"].device)
        mv = moves[action.long()]
        nr = torch.clamp(state["r"] + mv[0], 0, N - 1)
        nc = torch.clamp(state["c"] + mv[1], 0, N - 1)
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


def make(scenario_seed: Optional[int] = None) -> Env:
    walls, goal = resolve_board(scenario_seed)
    reset, step = _scalar_fns(walls, goal)
    kwargs = (None if scenario_seed is None
              else {"scenario_seed": int(scenario_seed)})
    return with_autoreset("gridmaze", reset, step, (N, N, 3), 4,
                          make_kwargs=kwargs)
