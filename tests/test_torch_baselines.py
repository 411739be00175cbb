"""The baselines (``core/baselines.py``): ``sync`` (A2C with the
alternating schedule) and ``async`` (stale behavior policy with a
correction).

* Against live JAX on the reference's runtime-test setup (catch, mlp,
  rmsprop 7e-4 eps 1e-5, alpha 5, n_envs 4, seed 3;
  ``tests/test_runtimes.py``), 6 intervals from the same params: the
  reward and done streams equal, params within 1e-5, for ``sync`` on
  both env backends and ``async`` at ``AsyncConfig.staleness`` 2 with
  each correction. On the goldens' alpha 4, ``async`` with no
  correction parts from JAX by 1.7e-5 in one ``w1`` entry (rmsprop's
  first step amplifies a gradient entry near 3e-6 whose fp32 rounding
  differs; ``PERF.md`` §6): there the streams are held exact and the
  first gradient within 1e-5 of its largest value.
* The capsules render JAX's treedef text, and a checkpoint written by
  either package continues in the other.
* Within the port, with ``torch.equal``: run(a + b) equals run(a) and
  run_from(b) through a checkpoint; sync applies its update with no
  delay where HTS lags one interval; async's staleness changes the
  training; the reference's guards raise (staleness != 1, ``acfg`` with
  field kwargs, a non-default batch geometry).
"""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.rollout import RolloutConfig, rollout_interval  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.envs.interfaces import vectorize  # noqa: E402
from repro.optim import rmsprop as jrmsprop  # noqa: E402
from repro_torch import api, bridge, envs, models, optim  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core import baselines, engine, trainer  # noqa: E402
from repro_torch.core.tree import treedef_str  # noqa: E402

INTERVALS = 6
PARAMS_TOL = 1e-5
CFG = dict(alpha=5, n_envs=4, seed=3)
CORRECTIONS = ("none", "epsilon", "trunc_is", "vtrace")

_memo = {}


def _kw(name, correction):
    return ({"acfg": baselines.AsyncConfig(staleness=2,
                                           correction=correction)}
            if name == "async" else {})


def _jparams():
    return jmodels.get_policy("mlp", jcatch.make()).init(jax.random.key(0))


def jax_rt(name, correction="none", env_backend="host", **cfg):
    env1 = jcatch.make()
    pol = jmodels.get_policy("mlp", env1)
    kw = ({} if name == "sync" else
          {"acfg": jbase.AsyncConfig(staleness=2, correction=correction)})
    return jengine.make_runtime(
        name, env1, pol.apply, _jparams(), jrmsprop(7e-4, eps=1e-5),
        jengine.HTSConfig(**{**CFG, **cfg}, env_backend=env_backend), **kw)


def jax_run(name, correction="none", env_backend="host"):
    key = (name, correction, env_backend)
    if key not in _memo:
        _memo[key] = jax_rt(name, correction, env_backend).run(INTERVALS)
    return _memo[key]


def port_rt(name, correction="none", env_backend="host", **cfg):
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    params = bridge.policy_params_from_jax(
        jax.tree.map(np.asarray, _jparams()))
    kw = cfg.pop("kw", _kw(name, correction))
    return engine.make_runtime(
        name, env1, pol.apply, params, optim.rmsprop(7e-4, eps=1e-5),
        engine.HTSConfig(**{**CFG, **cfg}, env_backend=env_backend),
        device="cpu", **kw)


def assert_matches(out, jout):
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    for k, v in jout.params.items():
        diff = np.abs(out.params[k].numpy() - np.asarray(v)).max()
        assert diff <= PARAMS_TOL, (k, diff)


def assert_same_run(a, b):
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    np.testing.assert_array_equal(a.rewards, b.rewards)
    np.testing.assert_array_equal(a.dones, b.dones)


# ------------------------------------------------------- against JAX
@pytest.mark.parametrize("env_backend", ["host", "device"])
def test_sync_matches_live_jax(env_backend):
    out = port_rt("sync", env_backend=env_backend).run(INTERVALS)
    assert_matches(out, jax_run("sync", env_backend=env_backend))


@pytest.mark.parametrize("correction", CORRECTIONS)
def test_async_matches_live_jax(correction):
    out = port_rt("async", correction).run(INTERVALS)
    assert_matches(out, jax_run("async", correction))


def _jax_traj(alpha):
    """Interval 0's trajectory at the initial params, as JAX collects
    it: numpy leaves."""
    env1 = jcatch.make()
    pol = jmodels.get_policy("mlp", env1)
    venv = vectorize(env1, CFG["n_envs"])
    env_state, obs = venv.reset(jax.random.split(
        jax.random.key(CFG["seed"] ^ 0x5EED), CFG["n_envs"]))
    traj, _, _ = rollout_interval(pol.apply, venv, _jparams(), env_state,
                                  obs, jax.random.key(CFG["seed"]), 0,
                                  RolloutConfig(alpha, CFG["n_envs"]))
    return jax.tree.map(np.asarray, traj)


def _port_pieces(jtraj):
    tpol = models.get_policy("mlp", envs.get_env("catch"))
    tparams = bridge.policy_params_from_jax(
        jax.tree.map(np.asarray, _jparams()))
    return tpol, tparams, {k: torch.from_numpy(np.array(v))
                          for k, v in jtraj.items()}


def test_async_without_correction_at_alpha4_streams_and_gradient():
    """The goldens' alpha 4: exact streams over 6 intervals, and the
    stale-loss gradient over interval 0's trajectory (JAX's, fed to
    both) within 1e-5 of its largest value, where the params after
    rmsprop steps part by 1.7e-5."""
    jout = jax_rt("async", alpha=4).run(INTERVALS)
    out = port_rt("async", alpha=4).run(INTERVALS)
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    jtraj = _jax_traj(4)
    pol = jmodels.get_policy("mlp", jcatch.make())
    jcfg = jengine.HTSConfig(**{**CFG, "alpha": 4})
    jg = jax.grad(lambda p: jbase._stale_loss(
        pol.apply, p, jtraj, jcfg, jbase.AsyncConfig(staleness=2)))(
            _jparams())
    tpol, tparams, ttraj = _port_pieces(jtraj)
    tcfg = engine.HTSConfig(**{**CFG, "alpha": 4})
    tg = torch.func.grad(lambda p: baselines._stale_loss(
        tpol.apply, p, ttraj, tcfg, baselines.AsyncConfig(staleness=2)))(
            tparams)
    scale = max(float(np.abs(np.asarray(v)).max()) for v in jg.values())
    for k, v in jg.items():
        diff = np.abs(tg[k].numpy() - np.asarray(v)).max()
        assert diff <= PARAMS_TOL * scale, (k, diff, scale)


def test_stale_loss_and_interval_loss_match_jax():
    """The pieces the baselines import: ``make_correction`` builds each
    mode from an AsyncConfig, ``_interval_loss`` resolves the configured
    algorithm; both losses equal JAX's at 1e-5 relative on JAX's
    trajectory."""
    from repro.core import mesh_runtime as jmesh
    from repro_torch.algorithms import vtrace as tvtrace
    from repro_torch.core import mesh_runtime as tmesh
    jtraj = _jax_traj(CFG["alpha"])
    japply = jmodels.get_policy("mlp", jcatch.make()).apply
    tpol, tparams, ttraj = _port_pieces(jtraj)

    def close(got, want, what):
        got, want = float(got), float(want)
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), (what, got,
                                                               want)

    for alg in ("a2c", "ppo", "vtrace"):
        close(tmesh._interval_loss(tpol.apply, tparams, ttraj,
                                   engine.HTSConfig(**CFG, algorithm=alg))[0],
              jmesh._interval_loss(japply, _jparams(), jtraj,
                                   jengine.HTSConfig(**CFG,
                                                     algorithm=alg))[0], alg)
    for corr in CORRECTIONS:
        acfg = baselines.AsyncConfig(correction=corr, epsilon=2e-3,
                                     rho_max=0.9)
        alg = tvtrace.make_correction(acfg)
        assert (alg.correction, alg.epsilon, alg.rho_max) == (corr, 2e-3,
                                                              0.9)
        close(baselines._stale_loss(tpol.apply, tparams, ttraj,
                                    engine.HTSConfig(**CFG), acfg),
              jbase._stale_loss(japply, _jparams(), jtraj,
                                jengine.HTSConfig(**CFG),
                                jbase.AsyncConfig(*acfg)), corr)


# ------------------------------------------------ capsules, checkpoints
@pytest.mark.parametrize("name", ["sync", "async"])
def test_capsule_treedef_is_jax_text(name):
    jrt, rt = jax_rt(name), port_rt(name)
    jrt.run(1)
    rt.run(1)
    state = rt.state()
    assert treedef_str(state) == str(jax.tree_util.tree_structure(
        jrt.state()))
    assert state.buffer == {} and state.interval.dtype == torch.int32
    if name == "async":
        params, _, history = state.algo
        assert all(history[k].shape == (2,) + params[k].shape
                   for k in params)


@pytest.mark.parametrize("name", ["sync", "async"])
def test_jax_writes_port_continues(tmp_path, name):
    jrt, rt = jax_rt(name, "vtrace"), port_rt(name, "vtrace")
    jrt.run(3)
    jstate = jrt.state()
    path = str(tmp_path / "step_00000003")
    jio.save(path, jstate, metadata={"intervals": 3})
    state = trainer.restore_capsule(path, rt.state())
    assert int(state.interval) == 3
    assert_matches(rt.run_from(state, 3), jrt.run_from(jstate, 3))


@pytest.mark.parametrize("name", ["sync", "async"])
def test_port_writes_jax_continues(tmp_path, name):
    jrt, rt = jax_rt(name, "trunc_is"), port_rt(name, "trunc_is")
    rt.run(3)
    state = rt.state()
    path = str(tmp_path / "step_00000003")
    ckpt_io.save(path, trainer.to_disk(state), metadata={"intervals": 3})
    manifest = json.loads(open(path + ".json").read())
    assert manifest["treedef"] == str(
        jax.tree_util.tree_structure(jrt.state()))
    jstate = jio.restore(path, jrt.state())      # every check of JAX's
    assert_matches(rt.run_from(state, 3), jrt.run_from(jstate, 3))


# ------------------------------------------------------- within the port
@pytest.mark.parametrize("name", ["sync", "async"])
def test_run_from_through_a_checkpoint_equals_run(tmp_path, name):
    """run(5) == run_from segments of 2 and 3 with a disk checkpoint
    round trip between them, bit for bit; the async snapshot FIFO rides
    in the capsule."""
    straight = port_rt(name).run(5)
    rt = port_rt(name)
    template = rt.state()
    state, rewards = template, []
    for i, n in enumerate((2, 3)):
        out = rt.run_from(state, n)
        rewards.append(out.rewards)
        path = str(tmp_path / f"boundary_{i}")
        ckpt_io.save(path, trainer.to_disk(rt.state()))
        state = trainer.restore_capsule(path, template)
    assert all(torch.equal(straight.params[k], out.params[k])
               for k in straight.params)
    np.testing.assert_array_equal(straight.rewards, np.concatenate(rewards))
    assert_same_run(port_rt(name).run(5), straight)      # a rerun


def test_sync_has_no_delay_hts_lags_one():
    """Sync updates at the params that collected the data, after every
    interval; HTS skips the first interval's update and then
    differentiates at the one-interval-old params."""
    params0 = port_rt("sync").params0
    sync = port_rt("sync")
    sync.run(1)
    assert any(not torch.equal(sync.state().algo[0][k], params0[k])
               for k in params0)
    hts = port_rt("mesh")
    hts.run(1)
    dg = hts.state().algo
    assert all(torch.equal(dg.params[k], params0[k]) for k in params0)
    hts.run_from(hts.state(), 1, finalize=False)
    dg = hts.state().algo
    assert all(torch.equal(dg.params_prev[k], params0[k]) for k in params0)
    assert any(not torch.equal(dg.params[k], params0[k]) for k in params0)


def test_async_staleness_changes_training():
    """A behavior policy 4 updates stale leaves the sync run within 8
    intervals (the first few can sample the same actions)."""
    stale = port_rt("async", kw={"staleness": 4}).run(8)
    sync = port_rt("sync").run(8)
    assert any(not torch.equal(stale.params[k], sync.params[k])
               for k in sync.params)


def test_guards():
    for name in ("sync", "async"):
        with pytest.raises(ValueError, match="staleness"):
            port_rt(name, staleness=2)
    with pytest.raises(TypeError, match="staleness"):
        port_rt("async", kw={"acfg": baselines.AsyncConfig(staleness=4),
                             "staleness": 16})
    assert port_rt("async", kw={"staleness": 4}).acfg.staleness == 4
    assert port_rt("async").acfg == baselines.AsyncConfig(staleness=2)


def test_spec_builds_the_baselines_as_jax_does():
    """``acfg`` JSON becomes an AsyncConfig; a non-default batch raises
    ValueError in both packages; bad acfg kwargs raise ValueError."""
    spec = dict(env="catch", hts=dict(CFG), runtime={
        "name": "async", "kwargs": {"acfg": {"staleness": 3,
                                             "correction": "vtrace"}}})
    session = api.build(api.ExperimentSpec(**spec), device="cpu")
    assert session.runtime.acfg == baselines.AsyncConfig(
        staleness=3, correction="vtrace")
    assert japi.build(japi.ExperimentSpec(**spec)).runtime.acfg == \
        jbase.AsyncConfig(staleness=3, correction="vtrace")
    out = session.run(2)
    assert out.rewards.shape == (2, CFG["alpha"], CFG["n_envs"])
    for build, S in ((lambda s: api.build(s, device="cpu"),
                      api.ExperimentSpec),
                     (japi.build, japi.ExperimentSpec)):
        with pytest.raises(ValueError, match="batch-geometry"):
            build(S(env="catch", runtime="sync", hts={"n_envs": 4},
                    batch={"grad_accumulation": 2}))
        with pytest.raises(ValueError, match="bad async runtime kwargs"):
            build(S(env="catch", runtime={"name": "async", "kwargs": {
                "acfg": {"lag": 3}}}))
