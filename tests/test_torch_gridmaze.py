"""Gridmaze in the port against the JAX package: ``sample_scenario``
boards equal, and the host env (``vectorize``, ``torch.func.vmap`` of the
scalar env) and the device port step exactly as JAX's
``vectorize(gridmaze.make(...))`` and JAX's device port: every state
leaf, obs, reward and done over 60 steps through autoresets (at the goal
and at the horizon), on the legacy board and ``scenario_seed`` 0-5 and
7. Actions come from a numpy generator with a seed, half of them
walking the board's shortest path so that goals are reached."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.envs import device as jdevice  # noqa: E402
from repro.envs import gridmaze as jgridmaze  # noqa: E402
from repro.envs.interfaces import vectorize as jvectorize  # noqa: E402
from repro_torch import envs  # noqa: E402
from repro_torch.core import determinism  # noqa: E402
from repro_torch.envs import device as tdevice  # noqa: E402
from repro_torch.envs import gridmaze  # noqa: E402
from repro_torch.envs.device import batched_env  # noqa: E402

SCENARIOS = [None, 0, 1, 2, 3, 4, 5, 7]
STEPS = 60
N_ENVS = 6


def _dist_to_goal(walls, goal):
    """BFS distance of every open cell to the goal (-1 unreachable)."""
    n = gridmaze.N
    dist = np.full((n, n), -1, np.int64)
    dist[goal] = 0
    frontier = [goal]
    while frontier:
        nxt = []
        for r, c in frontier:
            for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                rr, cc = r + dr, c + dc
                if 0 <= rr < n and 0 <= cc < n and walls[rr, cc] == 0 \
                        and dist[rr, cc] < 0:
                    dist[rr, cc] = dist[r, c] + 1
                    nxt.append((rr, cc))
        frontier = nxt
    return dist


def _actions(rng, state, walls, dist):
    """Per env: the shortest-path move with probability 1/2, else a
    uniform one."""
    moves = gridmaze.MOVES.numpy()
    n = gridmaze.N
    out = rng.integers(0, 4, N_ENVS)
    for e in range(N_ENVS):
        if rng.random() < 0.5:
            r, c = int(state["r"][e]), int(state["c"][e])
            best = []
            for a, (dr, dc) in enumerate(moves):
                rr = min(max(r + dr, 0), n - 1)
                cc = min(max(c + dc, 0), n - 1)
                if walls[rr, cc] == 0 and dist[rr, cc] >= 0:
                    best.append((dist[rr, cc], a))
            if best:
                out[e] = min(best)[1]
    return out.astype(np.int32)


@pytest.mark.parametrize("seed", range(12))
def test_sample_scenario_matches_jax(seed):
    walls, goal = gridmaze.sample_scenario(seed)
    jwalls, jgoal = jgridmaze.sample_scenario(seed)
    np.testing.assert_array_equal(walls, jwalls)
    assert walls.dtype == jwalls.dtype and goal == jgoal


def test_constants_and_legacy_board_match_jax():
    assert gridmaze.N == jgridmaze.N and gridmaze.HORIZON == jgridmaze.HORIZON
    np.testing.assert_array_equal(gridmaze.WALLS.numpy(),
                                  np.asarray(jgridmaze.WALLS))
    np.testing.assert_array_equal(gridmaze.MOVES.numpy(),
                                  np.asarray(jgridmaze.MOVES))
    assert gridmaze.WALLS.dtype == torch.float32
    assert gridmaze.MOVES.dtype == torch.int32


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_env_steps_match_jax(scenario, backend):
    kw = {} if scenario is None else {"scenario_seed": scenario}
    env = envs.get_env("gridmaze", **kw)
    assert env.make_kwargs == (kw or None)
    venv = batched_env(env, N_ENVS, backend)
    jenv1 = jgridmaze.make(scenario)
    jvenv = (jvectorize(jenv1, N_ENVS) if backend == "host"
             else jdevice.batched_env(jenv1, N_ENVS, "device"))
    jstep = jax.jit(jvenv.step)
    walls, goal = gridmaze.resolve_board(scenario)
    walls = walls.numpy()
    dist = _dist_to_goal(walls, goal)
    keys = determinism.split(determinism.master_key(scenario or 0), N_ENVS)
    jkeys = jax.random.split(jax.random.key(scenario or 0), N_ENVS)
    state, obs = venv.reset(keys)
    jstate, jobs = jvenv.reset(jkeys)
    rng = np.random.default_rng(100 + (scenario or 0))
    goals = horizons = 0
    for _ in range(STEPS):
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        for k in ("r", "c", "t"):
            assert state[k].dtype == torch.int32
            np.testing.assert_array_equal(state[k].numpy(),
                                          np.asarray(jstate[k]))
        a = _actions(rng, {k: v.numpy() for k, v in state.items()}, walls,
                     dist)
        state, obs, r, d = venv.step(state, torch.from_numpy(a), keys)
        jstate, jobs, jr, jd = jstep(jstate, jnp.asarray(a), jkeys)
        assert r.dtype == torch.float32 and d.dtype == torch.float32
        assert obs.dtype == torch.float32
        assert tuple(obs.shape) == (N_ENVS, gridmaze.N, gridmaze.N, 3)
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        goals += int((r.numpy() == 1.0).sum())
        horizons += int(((d.numpy() > 0) & (r.numpy() != 1.0)).sum())
    assert goals > 0, "no episode reached its goal: autoreset at the goal untested"
    if scenario is None:
        assert horizons > 0


def test_registry_and_device_ports():
    assert tdevice.device_port_names() == ["catch", "gridmaze"]
    assert tdevice.has_device_port("gridmaze")
    assert {"gridmaze", "gridmaze_device"} <= set(envs.env_names())
    port = envs.get_env("gridmaze_device", scenario_seed=7)
    assert isinstance(port, tdevice.DeviceEnv)
    assert port.host_name == "gridmaze" and port.n_actions == 4
    assert port.obs_shape == (gridmaze.N, gridmaze.N, 3)
    with pytest.raises(ValueError, match="no device-resident port"):
        tdevice.get_device_env("football")


@pytest.mark.parametrize("scenario", [None, 7])
def test_device_backend_keeps_the_scenario(scenario):
    """batched_env rebuilds the port from env.make_kwargs: a seeded
    board must survive it (the walls plane of the first obs)."""
    kw = {} if scenario is None else {"scenario_seed": scenario}
    venv = batched_env(envs.get_env("gridmaze", **kw), 2, "device")
    keys = determinism.split(determinism.master_key(0), 2)
    _, obs = venv.reset(keys)
    walls, goal = gridmaze.resolve_board(scenario)
    np.testing.assert_array_equal(obs[0, ..., 0].numpy(), walls.numpy())
    assert obs[0, goal[0], goal[1], 2] == 1.0 and obs[0, 0, 0, 1] == 1.0
