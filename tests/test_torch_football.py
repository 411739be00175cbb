"""The mini-football drill (``envs/football.py``) against live JAX, on the
CPU.

* ``make`` and ``make_multi(n)`` vectorized over 32 envs for 30 steps of
  seeded random actions, through auto-resets: rewards and dones exact,
  obs within 1e-6 (the reset's normals differ from XLA's by an ulp,
  ``determinism.normal``), the state's step counters exact.
* ``examples/specs/football_ppo.json`` (ppo, mlp, rmsprop, the threaded
  ``host`` runtime with 2 actors and its step-time model) through
  ``api.build`` in both packages, the reference's params carried across:
  after the spec's first intervals the reward and done streams are
  exact and the params within 1e-5.
"""
import faulthandler
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import determinism as jdet  # noqa: E402
from repro.envs import football as jfootball  # noqa: E402
from repro.envs import interfaces as jinterfaces  # noqa: E402
from repro_torch import api, bridge, envs  # noqa: E402
from repro_torch.core import determinism as tdet  # noqa: E402
from repro_torch.envs import football, interfaces  # noqa: E402

SPEC = str(Path(__file__).resolve().parents[1] / "examples" / "specs"
           / "football_ppo.json")
INTERVALS = 2
PARAMS_TOL = 1e-5
OBS_TOL = 1e-6


@pytest.fixture(autouse=True)
def watchdog():
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.mark.parametrize("n_players", [1, 2, 3])
def test_streams_match_jax(n_players):
    if n_players == 1:
        jenv, env = jfootball.make(), envs.get_env("football")
    else:
        jenv = jfootball.make_multi(n_players)
        env = football.make_multi(n_players)
    assert env.obs_shape == jenv.obs_shape
    assert env.n_actions == jenv.n_actions
    n, steps = 32, 30
    jv, tv = jinterfaces.vectorize(jenv, n), interfaces.vectorize(env, n)
    jm, tm = jdet.master_key(5), tdet.master_key(5)
    js, jo = jax.jit(jv.reset)(jdet.obs_keys(jm, jnp.arange(n), 0))
    ts, to = tv.reset(tdet.obs_keys(tm, torch.arange(n), 0))
    jstep = jax.jit(jv.step)
    rng = np.random.default_rng(n_players)
    dones = goals = 0
    for t in range(1, steps):
        a = rng.integers(0, env.n_actions, n)
        js, jo, jr, jd = jstep(js, jnp.asarray(a, jnp.int32),
                               jdet.obs_keys(jm, jnp.arange(n), t))
        ts, to, tr, td = tv.step(ts, torch.from_numpy(a),
                                 tdet.obs_keys(tm, torch.arange(n), t))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts["t"].numpy(), np.asarray(js["t"]))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OBS_TOL,
                                   rtol=0)
        dones += int(td.sum())
        goals += int(tr.sum())
    # the window ends episodes (shots, interceptions) and scores goals
    assert dones > 0 and (goals > 0 or n_players == 3)


def test_spec_through_api_build_matches_jax():
    jsession = japi.build(japi.load(SPEC))
    session = api.build(api.load(SPEC), device="cpu")
    assert session.runtime.name == "host" and session.spec.env.name == \
        "football"
    session.runtime.params0 = bridge.policy_params_from_jax(
        jax.tree.map(np.asarray, jsession.params))
    jout, out = jsession.run(INTERVALS), session.run(INTERVALS)
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    assert int(out.state.step) == int(jout.state.step) == INTERVALS
    assert float(np.asarray(out.dones).sum()) > 0
    for k, v in jout.params.items():
        diff = np.abs(out.params[k].numpy() - np.asarray(v)).max()
        assert diff <= PARAMS_TOL, (k, diff)
