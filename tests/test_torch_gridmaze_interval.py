"""One fused ``mesh`` interval on gridmaze (``scenario_seed`` 7) against
a live JAX ``MeshRuntime`` from the same params: the mlp and a reduced
paper CNN on the (N, N, 3) NHWC boards, a2c and ppo, K 1 and 2, on both
env backends. Reward and done streams exact, final params within 1e-5,
``step`` equal. The live JAX runs are memoised per configuration (the
backends give one trajectory, so each JAX run serves both).

``examples/atari_a2c.py``'s wider CNN on ``examples/specs/pool_b.json``:
its params after rmsprop steps are too sensitive to rounding for 1e-5
(the first step turns a gradient's rounding near |g| ~ 1e-5 into up to
lr/eps = 70 times itself), so it is held at exact streams over the
spec's 8 intervals and, on the first real learner pass from the same
state, at gradients within 1e-4 of the gradient tree's largest value.
Not per leaf: a ReLU whose input rounds to the other side of 0 in one
package passes or stops a whole term, which a small leaf (``v_b``, one
number) shows at its own scale."""
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.delayed_grad import behavior_params as jbehavior  # noqa: E402
from repro.core import mesh_runtime as jmesh  # noqa: E402
from repro.envs import gridmaze as jgridmaze  # noqa: E402
from repro.optim import rmsprop as jrmsprop  # noqa: E402
from repro_torch import api, bridge, envs, models, optim  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import mesh_runtime as tmesh  # noqa: E402
from repro_torch.core.delayed_grad import behavior_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
INTERVALS = 3
PARAMS_TOL = 1e-5
SCENARIO = 7
POLICIES = {"mlp": {"hidden": 32},
            "cnn": dict(conv_filters=(4, 8), conv_sizes=(3, 3),
                        conv_strides=(1, 1), hidden=16)}

_memo = {}


def _cfg(mod, algorithm, staleness, env_backend="host"):
    return mod.HTSConfig(alpha=4, n_envs=4, seed=3, algorithm=algorithm,
                         staleness=staleness, env_backend=env_backend)


def jax_run(policy, algorithm, staleness):
    key = (policy, algorithm, staleness)
    if key not in _memo:
        env1 = jgridmaze.make(SCENARIO)
        pol = jmodels.get_policy(policy, env1, **POLICIES[policy])
        params = pol.init(jax.random.key(0))
        out = jengine.make_runtime(
            "mesh", env1, pol.apply, params, jrmsprop(7e-4, eps=1e-5),
            _cfg(jengine, algorithm, staleness)).run(INTERVALS)
        _memo[key] = jax.tree.map(np.asarray, params), out
    return _memo[key]


@pytest.mark.parametrize("env_backend", ["host", "device"])
@pytest.mark.parametrize("staleness", [1, 2])
@pytest.mark.parametrize("algorithm", ["a2c", "ppo"])
@pytest.mark.parametrize("policy", ["mlp", "cnn"])
def test_gridmaze_interval_matches_live_jax(policy, algorithm, staleness,
                                            env_backend):
    jparams, jout = jax_run(policy, algorithm, staleness)
    env1 = envs.get_env("gridmaze", scenario_seed=SCENARIO)
    pol = models.get_policy(policy, env1, **POLICIES[policy])
    out = engine.make_runtime(
        "mesh", env1, pol.apply, bridge.policy_params_from_jax(jparams),
        optim.rmsprop(7e-4, eps=1e-5),
        _cfg(engine, algorithm, staleness, env_backend),
        device="cpu").run(INTERVALS)
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    assert int(out.state.step) == int(jout.state.step)
    ref = bridge.policy_params_to_reference(out.params)
    for k, v in jout.params.items():
        diff = np.abs(ref[k] - np.asarray(v)).max()
        assert diff <= PARAMS_TOL, (k, diff)


ATARI_A2C_CNN = {"name": "cnn", "kwargs": {"conv_sizes": [3, 3, 3],
                                           "conv_strides": [1, 1, 1],
                                           "hidden": 128}}
GRAD_REL_TOL = 1e-4


def test_atari_a2c_cnn_streams_and_first_pass_gradients_match_jax():
    spec = str(ROOT / "examples" / "specs" / "pool_b.json")
    jsession = japi.build(japi.load(spec).replace(policy=ATARI_A2C_CNN))
    session = api.build(api.load(spec).replace(policy=ATARI_A2C_CNN),
                        device="cpu")
    jparams = jax.tree.map(np.asarray, jsession.params)
    session.runtime.params0 = bridge.policy_params_from_jax(jparams)
    n = session.spec.intervals
    jout, out = jsession.run(n), session.run(n)
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    # the first real pass: K + 1 intervals in, from JAX's state
    K = session.cfg.staleness
    jrt = jsession.runtime
    jrt.run(K + 1)
    state = jax.tree.map(np.asarray, jrt.state())
    jgrads = jmesh.make_grad_fn(jsession.policy.apply, jsession.cfg)(
        jbehavior(state.algo), jmesh.ring_read(state.buffer, K))
    tstate = bridge.train_state_from_jax(state)
    grads = tmesh.make_grad_fn(session.policy.apply, session.cfg)(
        behavior_params(tstate.algo), tmesh.ring_read(tstate.buffer, K))
    ref = bridge.policy_params_to_reference(grads)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jgrads.values())
    for k, v in jgrads.items():
        err = float(np.abs(ref[k] - np.asarray(v)).max())
        assert err <= GRAD_REL_TOL * scale, (k, err, scale)
