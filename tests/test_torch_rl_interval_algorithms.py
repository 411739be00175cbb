"""The fused HTS-RL interval end to end, ppo and vtrace (a2c is in
``test_torch_rl_interval.py``), and a2c with GAE: the port's
``MeshRuntime`` against a live JAX ``MeshRuntime`` on the goldens'
configuration at K in {1, 2, 4} on both env backends (streams equal,
params within 1e-5, ``step`` equal), and the n < K edge of
``tests/test_staleness.py::test_run_shorter_than_staleness``."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from test_torch_rl_interval import (assert_matches_jax, jax_run,  # noqa: E402
                                    port_runtime)
from repro_torch import bridge  # noqa: E402


@pytest.mark.parametrize("env_backend", ["host", "device"])
@pytest.mark.parametrize("staleness", [1, 2, 4])
@pytest.mark.parametrize("algorithm", ["ppo", "vtrace"])
def test_algorithm_matches_live_jax(algorithm, staleness, env_backend):
    assert_matches_jax(algorithm, staleness, env_backend)


@pytest.mark.parametrize("env_backend", ["host", "device"])
def test_a2c_with_gae_matches_live_jax(env_backend):
    assert_matches_jax("a2c", 1, env_backend, use_gae=True)


def test_run_shorter_than_staleness():
    """n < K: only n real updates exist; the drain skips the ring slots
    no interval filled. Against JAX's mesh run at K=4, n=2."""
    assert_matches_jax("a2c", 4, "host", intervals=2)
    jparams, _ = jax_run("a2c", 4, intervals=2)
    out = port_runtime(staleness=4,
                       params=bridge.policy_params_from_jax(jparams)).run(2)
    assert int(out.state.step) == 2
    rt = port_runtime(staleness=4)
    rt.run(2)
    assert int(rt.state().algo.step) == 0
    assert tuple(rt.state().buffer["actions"].shape) == (4, 4, 4)
    assert rt.state().buffer["actions"].dtype == torch.int32
    np.testing.assert_array_equal(
        rt.state().buffer["dones"][:2].numpy(), np.ones((2, 4, 4)))
