"""Mini-football "academy" drill (GFootball stand-in).

Counterpart of ``repro/envs/football.py``. A striker and a defender on a
[0,1]^2 pitch, goal on the right edge. Actions: 8 movement directions +
shoot. The defender chases the ball carrier deterministically. A shot
succeeds with probability decreasing in distance-to-goal and defender
proximity, drawn from the executor key (``core.determinism.uniform``,
bit-exact with jax.random). Reward +1 on goal; an episode ends on goal,
on interception, on any shot, or at the horizon.

Observation: the 12-dim "extracted map" float vector (positions, deltas,
distances). ``make_multi(n)``: n players against the defender with a
shared score, a joint action space of 9^n.

Every norm is ``sqrt`` of the sum of squares, in fp32, as XLA lowers
``jnp.linalg.norm``; the reset's normals are ``determinism.normal``.
"""
from __future__ import annotations

import torch

from repro_torch.core import determinism
from repro_torch.envs.interfaces import Env, with_autoreset

HORIZON = 100
SPEED = 0.05
DEF_SPEED = 0.035


def _dirs() -> torch.Tensor:
    d = torch.tensor([[0, 1], [1, 1], [1, 0], [1, -1],
                      [0, -1], [-1, -1], [-1, 0], [-1, 1]],
                     dtype=torch.float32)
    return d / _norm(d)[:, None]


def _norm(x):
    return torch.sqrt((x * x).sum(-1))


DIRS = _dirs()


def _goal(device) -> torch.Tensor:
    return torch.tensor([1.0, 0.5], dtype=torch.float32, device=device)


def _f32(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _obs(state):
    p, d = state["player"], state["defender"]
    to_goal = _goal(p.device) - p
    to_def = d - p
    one = torch.ones((), dtype=torch.float32, device=p.device)
    return torch.cat([
        p, d, to_goal, to_def,
        torch.stack([_norm(to_goal), _norm(to_def)]),
        torch.stack([state["t"] / HORIZON, one]),
    ]).to(torch.float32)


def _reset(key):
    k = determinism.split(key)
    dev = key.device
    state = {
        "player": _f32([0.2, 0.5], dev)
        + 0.05 * determinism.normal(k[0], (2,)),
        "defender": _f32([0.7, 0.5], dev)
        + 0.05 * determinism.normal(k[1], (2,)),
        "t": torch.zeros((), dtype=torch.int32, device=dev),
    }
    return state, _obs(state)


def _move(pos, action):
    """The player at ``pos`` after ``action`` (a shot stands still) and
    whether it shot."""
    is_shot = action >= 8
    mv = DIRS.to(pos.device)[torch.clamp(action, max=7).long()] * SPEED
    step = torch.where(is_shot, 0.0, 1.0)
    return torch.clamp(pos + step * mv, 0.0, 1.0), is_shot


def _chase(defender, target):
    dvec = target - defender
    dn = dvec / (_norm(dvec) + 1e-6)
    return torch.clamp(defender + DEF_SPEED * dn, 0.0, 1.0)


def _step(state, action, key):
    p, is_shot = _move(state["player"], action)
    d = _chase(state["defender"], p)
    t = state["t"] + 1

    dist_goal = _norm(_goal(p.device) - p)
    dist_def = _norm(d - p)
    p_goal = torch.clamp(1.2 - 1.5 * dist_goal, 0.0, 0.95) * \
        torch.clamp(dist_def / 0.2, 0.0, 1.0)
    shot_scores = determinism.uniform(key, ()) < p_goal
    goal = is_shot & shot_scores
    intercepted = (dist_def < 0.03) & ~goal
    done = goal | intercepted | (t >= HORIZON) | is_shot
    reward = torch.where(goal, 1.0, 0.0).to(torch.float32)
    ns = {"player": p, "defender": d, "t": t}
    return ns, _obs(ns), reward, done.to(torch.float32)


def make() -> Env:
    return with_autoreset("minifootball", _reset, _step, (12,), 9)


# ------------------------------------------------- multi-player variant
def make_multi(n_players: int = 2) -> Env:
    """Paper Tab. 3: several players against the defender with a shared
    score. Joint action space (9^n, factored per player, player i's
    action the i-th base-9 digit); the ball carrier is the player closest
    to the goal, and teammates near the defender raise the scoring
    probability. Observation: the players' positions, the defender, the
    carrier's offset to the goal, the carrier one-hot, t / HORIZON."""
    A = 9 ** n_players
    obs_dim = 2 * n_players + 2 + 2 + n_players + 1

    def _mobs(state):
        ps, d = state["players"], state["defender"]
        goal = _goal(ps.device)
        carrier = torch.argmin(_norm(goal[None] - ps))
        return torch.cat([
            ps.reshape(-1), d, goal - ps[carrier],
            torch.nn.functional.one_hot(carrier, n_players).to(
                torch.float32),
            (state["t"] / HORIZON).reshape(1),
        ]).to(torch.float32)

    def _mreset(key):
        ks = determinism.split(key, n_players + 1)
        dev = key.device
        ps = torch.stack([
            _f32([0.2, 0.3 + 0.4 * i / max(n_players - 1, 1)], dev)
            + 0.05 * determinism.normal(ks[i], (2,))
            for i in range(n_players)])
        state = {"players": ps,
                 "defender": _f32([0.7, 0.5], dev)
                 + 0.05 * determinism.normal(ks[-1], (2,)),
                 "t": torch.zeros((), dtype=torch.int32, device=dev)}
        return state, _mobs(state)

    def _mstep(state, action, key):
        a = action
        moved, shoots = [], []
        for i in range(n_players):
            p, is_shot = _move(state["players"][i], a % 9)
            moved.append(p)
            shoots.append(is_shot)
            a = a // 9
        ps = torch.stack(moved)
        goal = _goal(ps.device)
        dists = _norm(goal[None] - ps)
        carrier = torch.argmin(dists)
        # the defender chases the carrier; only the carrier shoots
        d = _chase(state["defender"], ps[carrier])
        t = state["t"] + 1
        shot = torch.stack(shoots)[carrier]
        dist_goal = dists[carrier]
        dist_def = _norm(d - ps[carrier])
        # teammates near the defender pull attention: a bonus to p_goal
        others = _norm(ps - d[None])
        drag = torch.clamp(0.15 * (others < 0.25).sum() / n_players, 0.0,
                           0.3)
        p_goal = torch.clamp(1.2 - 1.5 * dist_goal + drag, 0.0, 0.95) * \
            torch.clamp(dist_def / 0.2, 0.0, 1.0)
        goal_scored = shot & (determinism.uniform(key, ()) < p_goal)
        intercepted = (dist_def < 0.03) & ~goal_scored
        done = goal_scored | intercepted | (t >= HORIZON) | shot
        reward = torch.where(goal_scored, 1.0, 0.0).to(torch.float32)
        ns = {"players": ps, "defender": d, "t": t}
        return ns, _mobs(ns), reward, done.to(torch.float32)

    return with_autoreset(f"minifootball{n_players}p", _mreset, _mstep,
                          (obs_dim,), A)
