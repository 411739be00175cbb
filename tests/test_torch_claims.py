"""The port's copies of the step-time models and of the paper's Claims 1
and 2 (``envs/steptime.py``, ``core/runtime_model.py``,
``core/stale_sim.py``) against the reference's functions on the same
inputs. Both sides are numpy and scipy, so every value is equal, not
close."""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import runtime_model as jrm  # noqa: E402
from repro.core import stale_sim as jss  # noqa: E402
from repro.envs import steptime as jst  # noqa: E402
from repro_torch.core import runtime_model, stale_sim  # noqa: E402
from repro_torch.envs import steptime  # noqa: E402

MODELS = ("CONSTANT", "LOW_VAR", "EXP_VAR", "HIGH_VAR")


@pytest.mark.parametrize("name", MODELS)
def test_step_time_models_equal_the_reference(name):
    ours, ref = getattr(steptime, name), getattr(jst, name)
    assert (ours.shape, ours.rate, ours.base) == (ref.shape, ref.rate,
                                                  ref.base)
    assert ours.mean == ref.mean and ours.variance == ref.variance
    for env_id, step, seed in ((0, 0, 0), (3, 17, 5), (15, 1000, 2 ** 31)):
        assert ours.sample(env_id, step, seed) == ref.sample(env_id, step,
                                                             seed)
    np.testing.assert_array_equal(ours.sample_batch(8, 16, seed=4),
                                  ref.sample_batch(8, 16, seed=4))


def test_step_time_with_base_and_busy_wait():
    m = steptime.StepTimeModel(shape=2.0, rate=4.0, base=0.25)
    r = jst.StepTimeModel(shape=2.0, rate=4.0, base=0.25)
    assert m.sample(1, 2, 3) == r.sample(1, 2, 3) >= 0.25
    assert m.mean == r.mean == 0.75
    steptime.busy_wait(0.0)
    steptime.busy_wait(1e-4)


@pytest.mark.parametrize("K,n,alpha,beta,c,shape", [
    (64000, 16, 4, 2.0, 0.0, 1.0), (64000, 16, 16, 2.0, 0.0, 1.0),
    (64000, 8, 4, 1.0, 0.01, 1.0), (32000, 16, 4, 0.25, 0.0, 0.25),
    (32000, 16, 4, 16.0, 0.05, 16.0),
])
def test_claim1_equals_the_reference(K, n, alpha, beta, c, shape):
    assert runtime_model.expected_runtime(
        K, n, alpha, beta, c, shape) == jrm.expected_runtime(
            K, n, alpha, beta, c, shape)
    for dist in ("exp", "uniform"):
        for seed in (0, 1):
            assert runtime_model.simulate_runtime(
                K, n, alpha, beta, c, seed, dist, shape) == \
                jrm.simulate_runtime(K, n, alpha, beta, c, seed, dist, shape)
    assert runtime_model.async_runtime(K, n, beta, c, seed=3) == \
        jrm.async_runtime(K, n, beta, c, seed=3)
    with pytest.raises(ValueError):
        runtime_model.simulate_runtime(K, n, alpha, beta, dist="normal")


def test_gamma_fit_equals_the_reference():
    samples = np.random.default_rng(0).gamma(4.0, 0.5, size=2000)
    assert runtime_model.gamma_fit_pvalue(samples) == \
        jrm.gamma_fit_pvalue(samples)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_claim2_equals_the_reference(n):
    lam0, mu = 100.0, 4000.0
    assert stale_sim.expected_latency(n, lam0, mu) == \
        jss.expected_latency(n, lam0, mu)
    assert stale_sim.simulate_latency(n, lam0, mu, horizon=50.0, seed=n) \
        == jss.simulate_latency(n, lam0, mu, horizon=50.0, seed=n)
    assert stale_sim.hts_latency(n) == jss.hts_latency(n) == 1
    assert stale_sim.expected_latency(n, mu, mu) == float("inf")


def test_pipeline_model_equals_the_reference():
    """``staleness_pipeline_runtime`` on random traces at every K, the
    reference's worked example, and its refusals."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        m = int(rng.integers(1, 30))
        R, L = rng.gamma(0.5, 2.0, size=m), rng.gamma(0.5, 2.0, size=m)
        for K in (1, 2, 4, 8, m + 1):
            assert runtime_model.staleness_pipeline_runtime(R, L, K) == \
                jrm.staleness_pipeline_runtime(R, L, K)
    R, L = [1.0, 3.0, 1.0, 3.0], [2.0] * 4
    assert runtime_model.staleness_pipeline_runtime(R, L, 1) == 11.0
    assert runtime_model.staleness_pipeline_runtime(R, L, 2) == 10.0
    assert runtime_model.staleness_pipeline_runtime([], [], 1) == 0.0
    with pytest.raises(ValueError, match="staleness"):
        runtime_model.staleness_pipeline_runtime(R, L, 0)
    with pytest.raises(ValueError, match="traces"):
        runtime_model.staleness_pipeline_runtime(R, L[:2], 1)
