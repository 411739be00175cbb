"""The functional training entry point ``core/mesh_runtime.py::train`` and
the paper's Fig. 5 claims on it (``tests/test_system.py``).

* Against live JAX: ``train(n)`` of the port and of the reference from
  the same params, on ``tests/test_runtimes.py``'s setup (catch, mlp,
  alpha 5, n_envs 4, seed 3, rmsprop 7e-4 eps 1e-5) at n in {1, 3, 4}
  and at K=2, and on ``test_system.py``'s token env (vocab 32 x 8 envs,
  alpha 8, hidden 64, rmsprop 5e-3, entropy 0.003) over 3 intervals: the
  reward and done streams equal, ``j`` equal, params and params_prev
  within 1e-5.
* Within the port (``torch.equal``): the last interval's trajectory is
  left unconsumed, so ``train(n + 1)``'s params are ``MeshRuntime.run(n)``'s
  and ``HostHTSRL.run(n)``'s; two calls are equal; ``unroll`` changes
  nothing and below 1 raises.
* The three Fig. 5 claims at ``test_system.py``'s setup and thresholds
  (120 intervals, the tail a quarter), from the port's own seed-0 params:
  HTS learns, keeps 0.6x sync A2C's tail reward, and is no worse than
  16-stale async without correction. The port's HTS, sync and async runs
  are made once per module; a failure message also gives the
  reference's tail rewards, run only then.
"""
import faulthandler
from typing import NamedTuple

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import models as jmodels  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import mesh_runtime as jmesh  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.envs import token_env as jtoken  # noqa: E402
from repro.envs.interfaces import vectorize as jvectorize  # noqa: E402
from repro.models import cnn_policy as jcnn  # noqa: E402
from repro.optim import rmsprop as jrmsprop  # noqa: E402
from repro_torch import bridge, envs, models, optim  # noqa: E402
from repro_torch.core import baselines, determinism, engine  # noqa: E402
from repro_torch.core import mesh_runtime as tmesh  # noqa: E402
from repro_torch.core.host_runtime import HostConfig, HostHTSRL  # noqa: E402
from repro_torch.envs import token_env  # noqa: E402
from repro_torch.envs.interfaces import vectorize  # noqa: E402
from repro_torch.models import cnn_policy  # noqa: E402

PARAMS_TOL = 1e-5
VOCAB = 32
N_INTERVALS = 120

_memo = {}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The runs here are thousands of ops on tensors of a few hundred
    elements, where handing each op to torch's intra-op pool costs more
    than the op: one thread runs them several times faster, the more so
    when other test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ setups
class Setup(NamedTuple):
    env1: object
    venv: object
    cfg: engine.HTSConfig
    apply: object
    params: dict
    opt: object
    jax: tuple          # (venv, cfg, apply, params, opt) of the reference


def catch_setup(staleness=1):
    """test_runtimes' configuration; the port's params are JAX's, bridged."""
    jenv1 = jcatch.make()
    jpol = jmodels.get_policy("mlp", jenv1)
    jparams = jpol.init(jax.random.key(0))
    env1 = envs.get_env("catch")
    return Setup(
        env1, vectorize(env1, 4),
        engine.HTSConfig(alpha=5, n_envs=4, seed=3, staleness=staleness),
        models.get_policy("mlp", env1).apply,
        bridge.policy_params_from_jax(jax.tree.map(np.asarray, jparams)),
        optim.rmsprop(7e-4, eps=1e-5),
        (jvectorize(jenv1, 4),
         jmesh.HTSConfig(alpha=5, n_envs=4, seed=3, staleness=staleness),
         jpol.apply, jparams, jrmsprop(7e-4, eps=1e-5)))


def token_setup(params=None):
    """test_system.py's token env setup; ``params`` None bridges JAX's."""
    jparams = jcnn.init_token_policy(jax.random.key(0), VOCAB, hidden=64)
    if params is None:
        params = bridge.policy_params_from_jax(
            jax.tree.map(np.asarray, jparams))
    env1 = token_env.make(vocab=VOCAB, seed=1)
    return Setup(
        env1, vectorize(env1, 8),
        engine.HTSConfig(alpha=8, n_envs=8, seed=0, entropy_coef=0.003),
        cnn_policy.apply_token_policy, params, optim.rmsprop(5e-3, eps=1e-5),
        (jvectorize(jtoken.make(vocab=VOCAB, seed=1), 8),
         jmesh.HTSConfig(alpha=8, n_envs=8, seed=0, entropy_coef=0.003),
         jcnn.apply_token_policy, jparams, jrmsprop(5e-3, eps=1e-5)))


def jax_train(name, n, staleness=1):
    """The reference's ``train(n)`` (memoised): (DelayedGradState, j,
    metrics), numpy leaves."""
    key = (name, n, staleness)
    if key not in _memo:
        s = catch_setup(staleness) if name == "catch" else token_setup()
        venv, jcfg, japply, jparams, jopt = s.jax
        carry, metrics = jmesh.train(jparams, japply, venv, jopt, jcfg, n)
        _memo[key] = (jax.tree.map(np.asarray, carry[0]),
                      int(carry[4]), jax.tree.map(np.asarray, metrics))
    return _memo[key]


def port_train(s: Setup, n, **kw):
    return tmesh.train(s.params, s.apply, s.venv, s.opt, s.cfg, n,
                       device="cpu", **kw)


def assert_matches_jax(name, n, staleness=1):
    s = catch_setup(staleness) if name == "catch" else token_setup()
    carry, metrics = port_train(s, n)
    jdg, jj, jmetrics = jax_train(name, n, staleness)
    for k in ("rewards", "dones"):
        assert metrics[k].shape == (n, s.cfg.alpha, s.cfg.n_envs)
        assert metrics[k].dtype == torch.float32
        np.testing.assert_array_equal(metrics[k].numpy(), jmetrics[k])
    assert carry[4].dtype == torch.int32 and carry[4].device.type == "cpu"
    assert int(carry[4]) == jj == n
    jdg = bridge.delayed_grad_from_jax(jdg)
    assert int(carry[0].step) == int(jdg.step)
    for field in ("params", "params_prev"):
        ours, ref = getattr(carry[0], field), getattr(jdg, field)
        for k in ref:
            diff = (ours[k] - ref[k]).abs().max().item()
            assert diff <= PARAMS_TOL, (field, k, diff)


# ------------------------------------------------- against live JAX
@pytest.mark.parametrize("n,staleness", [(1, 1), (3, 1), (4, 1), (3, 2)])
def test_train_matches_live_jax_catch(n, staleness):
    assert_matches_jax("catch", n, staleness)


def test_train_matches_live_jax_token():
    assert_matches_jax("token", 3)


# ---------------------------------------------------- within the port
def _assert_params_equal(a, b):
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_train_leaves_the_last_trajectory_unconsumed():
    """train(n + 1) applies n updates: its params are MeshRuntime.run(n)'s,
    whose trailing learner pass consumes the ring instead."""
    s = catch_setup()
    carry, metrics = port_train(s, 4)
    out = engine.make_runtime("mesh", s.env1, s.apply, s.params, s.opt,
                              s.cfg, device="cpu").run(3)
    _assert_params_equal(carry[0].params, out.params)
    assert int(carry[0].step) == int(out.state.step) == 3
    np.testing.assert_array_equal(metrics["rewards"][:3].numpy(),
                                  out.rewards)


def test_train_equals_the_host_runtime():
    """The counterpart of test_runtimes' host == mesh, bit for bit."""
    s = catch_setup()
    carry, _ = port_train(s, 4)
    faulthandler.dump_traceback_later(120, exit=True)
    try:
        out = HostHTSRL(s.env1, s.apply, s.params, s.opt, s.cfg,
                        HostConfig(n_actors=2), device="cpu").run(3)
    finally:
        faulthandler.cancel_dump_traceback_later()
    _assert_params_equal(carry[0].params, out.state.params)


def test_train_rerun_and_unroll_are_bit_identical():
    s = catch_setup()
    a, ma = port_train(s, 3)
    b, mb = port_train(s, 3, unroll=4)
    _assert_params_equal(a[0].params, b[0].params)
    _assert_params_equal(a[0].params_prev, b[0].params_prev)
    assert torch.equal(ma["rewards"], mb["rewards"])
    assert torch.equal(ma["dones"], mb["dones"])
    # the caller's params are copied, not trained in place
    _assert_params_equal(s.params, catch_setup().params)


def test_train_edges():
    s = catch_setup()
    with pytest.raises(ValueError, match="unroll must be >= 1"):
        port_train(s, 2, unroll=0)
    carry, metrics = port_train(s, 0)
    assert metrics["rewards"].shape == (0, 5, 4)
    assert int(carry[4]) == 0
    _assert_params_equal(carry[0].params, s.params)


# ------------------------------------------------------ Fig. 5 claims
def _tail(rewards, frac=0.25):
    r = np.asarray(rewards)
    n = max(1, int(r.shape[0] * frac))
    return float(r[-n:].mean())


ACFG = dict(staleness=16, correction="none")


@pytest.fixture(scope="module")
def fig5():
    """The port's three 120-interval runs from its own seed-0 params."""
    params = cnn_policy.init_token_policy(determinism.master_key(0), VOCAB,
                                          hidden=64)
    s = token_setup(params)
    venv, cfg, apply, opt = s.venv, s.cfg, s.apply, s.opt
    _, hts = port_train(s, N_INTERVALS)
    sync = engine.scan_intervals(
        baselines.make_sync_step(apply, venv, opt, cfg, device="cpu"),
        baselines.sync_init_carry(params, opt, venv, cfg, device="cpu"),
        N_INTERVALS, cfg)[1]
    acfg = baselines.AsyncConfig(**ACFG)
    stale = engine.scan_intervals(
        baselines.make_async_step(apply, venv, opt, cfg, acfg,
                                  device="cpu"),
        baselines.async_init_carry(params, opt, venv, cfg, acfg,
                                   device="cpu"),
        N_INTERVALS, cfg)[1]
    return {k: m["rewards"].numpy() for k, m in
            (("hts", hts), ("sync", sync), ("stale", stale))}


def _jax_tails():
    """The reference's three runs at test_system.py's setup (only for a
    failure message)."""
    if "fig5" not in _memo:
        venv, jcfg, japply, jparams, jopt = token_setup().jax
        runs = {"hts": jmesh.train(jparams, japply, venv, jopt, jcfg,
                                   N_INTERVALS)[1]}
        sstep = jbase.make_sync_step(japply, venv, jopt, jcfg)
        runs["sync"] = jax.jit(lambda c: jax.lax.scan(
            sstep, c, None, length=N_INTERVALS))(
                jbase.sync_init_carry(jparams, jopt, venv, jcfg))[1]
        acfg = jbase.AsyncConfig(**ACFG)
        astep = jbase.make_async_step(japply, venv, jopt, jcfg, acfg)
        runs["stale"] = jax.jit(lambda c: jax.lax.scan(
            astep, c, None, length=N_INTERVALS))(
                jbase.async_init_carry(jparams, jopt, venv, jcfg, acfg))[1]
        _memo["fig5"] = {k: _tail(m["rewards"]) for k, m in runs.items()}
    return _memo["fig5"]


def _why(fig5):
    ours = {k: round(_tail(v), 4) for k, v in fig5.items()}
    ref = {k: round(v, 4) for k, v in _jax_tails().items()}
    return f"tail rewards: port {ours}, reference (live JAX) {ref}"


def test_hts_learns(fig5):
    early = float(fig5["hts"][:5].mean())
    late = _tail(fig5["hts"])
    assert late > early + 0.05, (early, late, _why(fig5))
    assert late > 0.15, (late, _why(fig5))


def test_hts_matches_sync_sample_efficiency(fig5):
    """Fig. 5 top row: the one-interval delay keeps >= 0.6x sync's tail."""
    hts, sync = _tail(fig5["hts"]), _tail(fig5["sync"])
    assert hts > 0.6 * sync, (hts, sync, _why(fig5))


def test_stale_async_hurts_sample_efficiency(fig5):
    """Fig. 5 / Sec. 3: 16-stale async without correction is no better."""
    hts, stale = _tail(fig5["hts"]), _tail(fig5["stale"])
    assert hts >= stale - 0.05, (hts, stale, _why(fig5))
