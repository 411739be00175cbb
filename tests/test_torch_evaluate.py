"""The port's evaluation protocol (``core/evaluate.py``).

Hypothesis properties: ``episode_returns_from_stream`` and a
``ReturnStream`` fed in any chunking (with a ``state_dict`` round trip
through JSON at every chunk boundary) equal the loop oracle
``_episode_returns_loop`` of the JAX package, T = 0 included. The
streams are built with explicit (T, N) shapes, so an empty T keeps its
N. Integer-valued rewards must match exactly (the f64 cumsums are
exact); gridmaze-like rewards (+1, -0.01) within 1e-12 relative.
``evaluate_policy`` on catch and gridmaze, greedy and sampled with
no-ops, equals the JAX package's on the same params."""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import envs as jenvs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.core import evaluate as jevaluate  # noqa: E402
from repro_torch import bridge, envs, models  # noqa: E402
from repro_torch.core import evaluate  # noqa: E402

SET = dict(max_examples=60, deadline=None)


@st.composite
def streams(draw, values):
    T = draw(st.integers(0, 10))
    N = draw(st.integers(1, 5))
    r = np.array(draw(st.lists(values, min_size=T * N, max_size=T * N)),
                 np.float64).reshape(T, N)
    d = np.array(draw(st.lists(st.booleans(), min_size=T * N,
                               max_size=T * N)), bool).reshape(T, N)
    cuts = sorted(draw(st.lists(st.integers(0, T), max_size=4)))
    return r, d, cuts


INTS = st.integers(-10, 10).map(float)
GRIDMAZE = st.sampled_from([1.0, -0.01, 0.0])


def _check(r, d, cuts, exact):
    want = jevaluate._episode_returns_loop(r, d)
    one_shot = evaluate.episode_returns_from_stream(r, d)
    stream = evaluate.ReturnStream(r.shape[1])
    for lo, hi in zip([0] + cuts, cuts + [r.shape[0]]):
        stream.extend(r[lo:hi], d[lo:hi])
        state = json.loads(json.dumps(stream.state_dict()))
        stream = evaluate.ReturnStream(r.shape[1]).load_state_dict(state)
    for got in (one_shot, stream.returns):
        assert got.shape == want.shape
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert stream.n_total == len(want)


@given(streams(INTS))
@settings(**SET)
def test_integer_rewards_match_the_loop_oracle(s):
    _check(*s, exact=True)


@given(streams(GRIDMAZE))
@settings(**SET)
def test_gridmaze_rewards_match_the_loop_oracle(s):
    _check(*s, exact=False)


def test_empty_stream_and_metrics():
    r = np.zeros((0, 3))
    d = np.zeros((0, 3), bool)
    assert evaluate.episode_returns_from_stream(r, d).shape == (0,)
    assert np.isnan(evaluate.final_metric(r, d))
    stream = evaluate.ReturnStream(3)
    stream.extend(r, d)
    assert np.isnan(stream.final_metric()) and stream.n_total == 0
    with pytest.raises(ValueError, match="n_envs"):
        evaluate.ReturnStream(2).load_state_dict(stream.state_dict())
    rng = np.random.default_rng(0)
    r = rng.integers(-1, 2, (40, 4)).astype(np.float64)
    d = rng.random((40, 4)) < 0.2
    times = rng.random(40)
    assert evaluate.final_metric(r, d, 5) == jevaluate.final_metric(r, d, 5)
    assert evaluate.final_time_metric(r, d, times, 10.0) == \
        jevaluate.final_time_metric(r, d, times, 10.0)
    assert evaluate.required_time_metric(r, d, times, 0.5, 3) == \
        jevaluate.required_time_metric(r, d, times, 0.5, 3)
    assert evaluate.bootstrap_ci(r.ravel(), n_boot=200) == \
        jevaluate.bootstrap_ci(r.ravel(), n_boot=200)


@pytest.mark.parametrize("greedy,noop_max", [(True, 0), (False, 3)])
@pytest.mark.parametrize("env_name", ["catch", "gridmaze"])
def test_evaluate_policy_matches_jax(env_name, greedy, noop_max):
    jenv = jenvs.get_env(env_name)
    jpol = jmodels.get_policy("mlp", jenv)
    params = jpol.init(jax.random.key(5))
    env = envs.get_env(env_name)
    pol = models.get_policy("mlp", env)
    kw = dict(n_episodes=4, max_steps=40, greedy=greedy, noop_max=noop_max,
              seed=2)
    want = jevaluate.evaluate_policy(jpol.apply, params, jenv, **kw)
    got = evaluate.evaluate_policy(
        pol.apply, bridge.policy_params_from_jax(
            jax.tree.map(np.asarray, params)), env, **kw)
    np.testing.assert_array_equal(got, want)
