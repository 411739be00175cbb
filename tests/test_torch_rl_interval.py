"""The fused HTS-RL interval end to end, a2c: ``engine.make_runtime(
"mesh", ...)`` of the port against a live JAX ``MeshRuntime`` run on the
goldens' configuration (catch, mlp, rmsprop 7e-4 eps 1e-5, alpha 4,
n_envs 4, seed 3, 3 intervals; ``tests/test_goldens.py``), from the same
params: the reward and done streams equal, the final params within 1e-5,
``step`` equal, at K in {1, 2, 4} and on both env backends. Within the
port: a rerun and every ``run``/``run_from`` partition are bit-exact
(``torch.equal``), and ``run(n)`` applies exactly n updates at every K.
The live JAX runs are memoised per configuration."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import models as jmodels  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import mesh_runtime as jmesh  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.optim import rmsprop as jrmsprop  # noqa: E402
from repro_torch import bridge, envs, models, optim  # noqa: E402
from repro_torch.core import determinism as tdet  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import mesh_runtime as tmesh  # noqa: E402

INTERVALS = 3
PARAMS_TOL = 1e-5

_memo = {}


def jax_run(algorithm="a2c", staleness=1, use_gae=False,
            intervals=INTERVALS):
    """The reference's mesh run (memoised): (init params, RunResult)."""
    key = (algorithm, staleness, use_gae, intervals)
    if key not in _memo:
        env1 = jcatch.make()
        cfg = jengine.HTSConfig(alpha=4, n_envs=4, seed=3,
                                algorithm=algorithm, staleness=staleness,
                                use_gae=use_gae)
        pol = jmodels.get_policy("mlp", env1)
        params = pol.init(jax.random.key(0))
        out = jengine.make_runtime("mesh", env1, pol.apply, params,
                                   jrmsprop(7e-4, eps=1e-5), cfg).run(
                                       intervals)
        _memo[key] = jax.tree.map(np.asarray, params), out
    return _memo[key]


def port_runtime(algorithm="a2c", staleness=1, env_backend="host",
                 use_gae=False, params=None, **kw):
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    cfg = engine.HTSConfig(alpha=4, n_envs=4, seed=3, algorithm=algorithm,
                           staleness=staleness, env_backend=env_backend,
                           use_gae=use_gae)
    if params is None:
        params = pol.init(tdet.master_key(0))
    return engine.make_runtime("mesh", env1, pol.apply, params,
                               optim.rmsprop(7e-4, eps=1e-5), cfg,
                               device="cpu", **kw)


def assert_matches_jax(algorithm, staleness, env_backend, use_gae=False,
                       intervals=INTERVALS):
    jparams, jout = jax_run(algorithm, staleness, use_gae, intervals)
    out = port_runtime(algorithm, staleness, env_backend, use_gae,
                       params=bridge.policy_params_from_jax(jparams)).run(
                           intervals)
    assert out.rewards.dtype == np.float32 and out.dones.dtype == np.float32
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    assert int(out.state.step) == int(jout.state.step) == intervals
    assert out.state.step.dtype == torch.int32
    for k, v in jout.params.items():
        diff = np.abs(out.params[k].numpy() - np.asarray(v)).max()
        assert diff <= PARAMS_TOL, (k, diff)


@pytest.mark.parametrize("env_backend", ["host", "device"])
@pytest.mark.parametrize("staleness", [1, 2, 4])
def test_a2c_matches_live_jax(staleness, env_backend):
    assert_matches_jax("a2c", staleness, env_backend)


def _assert_same_run(a, b):
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    np.testing.assert_array_equal(a.rewards, b.rewards)
    np.testing.assert_array_equal(a.dones, b.dones)
    assert int(a.state.step) == int(b.state.step)


@pytest.mark.parametrize("env_backend", ["host", "device"])
def test_rerun_is_bit_identical(env_backend):
    """The paper's "bit-identical rerun": run(n) twice on one runtime,
    and on a fresh one."""
    rt = port_runtime(env_backend=env_backend)
    a = rt.run(6)
    _assert_same_run(a, rt.run(6))
    _assert_same_run(a, port_runtime(env_backend=env_backend).run(6))


def test_backends_give_the_same_run():
    _assert_same_run(port_runtime(env_backend="host").run(5),
                     port_runtime(env_backend="device").run(5))


@pytest.mark.parametrize("staleness", [1, 2, 4])
def test_run_from_partitions_equal_run(staleness):
    """run(a + b) == run(a), state(), run_from(state, b), bit for bit, and
    so for three segments with mid-stream (finalize=False) reports."""
    full = port_runtime(staleness=staleness).run(6)
    rt = port_runtime(staleness=staleness)
    first = rt.run(2)
    second = rt.run_from(rt.state(), 4)
    _assert_same_run(full, type(full)(**{**vars(second), "rewards":
                                         np.concatenate([first.rewards,
                                                         second.rewards]),
                                         "dones": np.concatenate(
                                             [first.dones, second.dones])}))
    rt = port_runtime(staleness=staleness)
    rt.run(1)
    parts = [rt.run_from(rt.state(), 3, finalize=False)]
    parts.append(rt.run_from(rt.state(), 2))
    assert all(torch.equal(full.params[k], parts[-1].params[k])
               for k in full.params)
    np.testing.assert_array_equal(full.rewards[1:], np.concatenate(
        [p.rewards for p in parts]))


def test_state_is_a_copy():
    """state() copies on capture and run_from on restore: neither the
    capsule nor the runtime sees the other's later writes."""
    rt = port_runtime()
    rt.run(2)
    capsule = rt.state()
    want = rt.run_from(capsule, 2)
    capsule2 = rt.state()
    capsule2.algo.params["w1"].add_(1.0)
    capsule2.obs.add_(1.0)
    assert not torch.equal(capsule2.algo.params["w1"],
                           rt.state().algo.params["w1"])
    got = rt.run_from(capsule, 2)
    _assert_same_run(want, got)
    assert capsule.interval.dtype == torch.int32 and int(capsule.interval) == 2


def test_update_counts_match_across_staleness():
    """run(n) applies n updates at every K; the mid-stream state is K
    updates behind the reported params."""
    for K in (1, 2, 4):
        rt = port_runtime(staleness=K)
        assert int(rt.run(5).state.step) == 5
        assert int(rt.state().algo.step) == 5 - K


def test_run_zero_keeps_the_initial_params():
    rt = port_runtime()
    params = bridge.policy_params_from_jax(jax_run()[0])
    out = port_runtime(params=params).run(0)
    assert all(torch.equal(out.params[k], params[k]) for k in params)
    assert int(out.state.step) == 0 and out.rewards.shape == (0, 4, 4)
    assert rt.name == "mesh"


def test_episode_returns_match_jax():
    _, jout = jax_run()
    want = np.asarray(jmesh.episode_returns(
        {"rewards": jout.rewards, "dones": jout.dones}))
    got = tmesh.episode_returns({"rewards": jout.rewards.copy(),
                                 "dones": jout.dones.copy()}).numpy()
    np.testing.assert_array_equal(np.isnan(want), np.isnan(got))
    np.testing.assert_array_equal(want[~np.isnan(want)],
                                  got[~np.isnan(got)])


def test_runtime_registry():
    names = ["async", "host", "mesh", "sharded", "sync"]
    assert engine.runtime_names() == sorted(names + ["serve"])
    assert engine.training_runtime_names() == names
    assert engine.get_runtime("mesh") is tmesh.MeshRuntime
    assert engine.get_runtime("host").name == "host"
    assert engine.get_runtime("sharded").name == "sharded"
    with pytest.raises(KeyError, match="registered: \\['async', 'host', "
                       "'mesh', 'serve', 'sharded', 'sync'\\]"):
        engine.get_runtime("stream")
    with pytest.raises(ValueError, match="staleness"):
        port_runtime(staleness=0)
    with pytest.raises(ValueError, match="unknown env_backend"):
        port_runtime(env_backend="tpu")
    assert isinstance(port_runtime(), engine.Runtime)


def test_runtime_refuses_the_cpu_unless_asked(monkeypatch):
    """The runtime runs on the card; without CUDA it raises unless the
    caller passes device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    args = (env1, pol.apply, pol.init(tdet.master_key(0)),
            optim.rmsprop(7e-4), engine.HTSConfig(alpha=2, n_envs=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        engine.make_runtime("mesh", *args)
    assert engine.make_runtime("mesh", *args, device="cpu").device == \
        torch.device("cpu")


def _builders():
    """Each functional builder of the port on a 2 x 2 catch run: name ->
    (call(**kw), j after driving what the call returned on the CPU, the
    expected j)."""
    from repro_torch.core import baselines as tb
    from repro_torch.envs.interfaces import vectorize
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    venv, cfg = vectorize(env1, 2), engine.HTSConfig(alpha=2, n_envs=2)
    params, opt = pol.init(tdet.master_key(0)), optim.rmsprop(7e-4)
    acfg = tb.AsyncConfig(staleness=2)
    hts = (tmesh.make_hts_step, tmesh.init_carry, ())
    sync = (tb.make_sync_step, tb.sync_init_carry, ())
    stale = (tb.make_async_step, tb.async_init_carry, (acfg,))
    out = {"train": (lambda **kw: tmesh.train(params, pol.apply, venv, opt,
                                              cfg, 2, **kw),
                     lambda res: res[0][-1], 2)}
    for make, init, extra in (hts, sync, stale):
        def carry(init=init, extra=extra, **kw):
            return init(params, opt, venv, cfg, *extra, **kw)

        def step(make=make, extra=extra, **kw):
            return make(pol.apply, venv, opt, cfg, *extra, **kw)

        out[init.__name__] = (carry, lambda c: c[-1], 0)
        out[make.__name__] = (
            step, lambda f, carry=carry: f(carry(device="cpu"))[0][-1], 1)
    return out


@pytest.mark.parametrize("name", [
    "make_hts_step", "init_carry", "train", "make_sync_step",
    "sync_init_carry", "make_async_step", "async_init_carry"])
def test_functional_builders_refuse_the_cpu_unless_asked(monkeypatch, name):
    """The functional entry points run on the card too: ``device=None``
    means ``cuda``, and without CUDA only ``device="cpu"`` runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call, j_of, expected = _builders()[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    j = j_of(call(device="cpu"))
    assert j.device.type == "cpu" and int(j) == expected


@pytest.mark.parametrize("env_offset", [0, 3])
def test_rollout_interval_matches_jax(env_offset):
    """One interval of the rollout half on its own: the env ids shifted by
    ``env_offset`` seed the actions and (at + 1_000_003) the transitions;
    obs, actions, rewards and dones equal JAX's, the fp32 behavior
    logprobs within 1e-6, every leaf in the reference's dtype."""
    import jax.numpy as jnp
    from repro.core import rollout as jrollout
    from repro.envs.interfaces import vectorize
    from repro_torch.core import rollout as trollout
    jparams, _ = jax_run()
    jenv = vectorize(jcatch.make(), 4)
    jpol = jmodels.get_policy("mlp", jcatch.make())
    js, jo = jenv.reset(jax.random.split(jax.random.key(7), 4))
    jtraj, _, _ = jax.jit(
        lambda s, o: jrollout.rollout_interval(
            jpol.apply, jenv, jax.tree.map(jnp.asarray, jparams), s, o,
            jax.random.key(3), 8, jrollout.RolloutConfig(12, 4),
            env_offset=env_offset))(js, jo)
    tenv = envs.get_env("catch_device")
    ts, to = tenv.reset(tdet.split(tdet.master_key(7), 4))
    ttraj, _, _ = trollout.rollout_interval(
        models.get_policy("mlp", envs.get_env("catch")).apply,
        tenv, bridge.policy_params_from_jax(jparams), ts, to,
        tdet.master_key(3), 8, trollout.RolloutConfig(12, 4),
        env_offset=env_offset)
    assert set(ttraj) == set(jtraj)
    for k, v in jtraj.items():
        want = np.asarray(v)
        got = ttraj[k].numpy()
        assert got.dtype == want.dtype, k
        if k == "behavior_logprob":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want, k)


@pytest.mark.parametrize("staleness", [1, 2])
def test_jax_capsule_continues_in_the_port(staleness):
    """A JAX run's mid-stream capsule after 2 intervals, carried across
    the bridge, continues in the port: leaves in ``jax.tree_util`` order
    (the order the reference's checkpoints number them), and
    ``run_from(capsule, 1)`` gives the third interval of JAX's run(3):
    its streams exactly, params within 1e-5, step equal."""
    jparams, jout = jax_run("a2c", staleness)
    env1 = jcatch.make()
    pol = jmodels.get_policy("mlp", env1)
    rt = jengine.make_runtime(
        "mesh", env1, pol.apply, jax.tree.map(jax.numpy.asarray, jparams),
        jrmsprop(7e-4, eps=1e-5),
        jengine.HTSConfig(alpha=4, n_envs=4, seed=3, staleness=staleness))
    rt.run(2)
    capsule = jax.tree.map(np.asarray, rt.state())
    tcapsule = bridge.train_state_from_jax(capsule)
    want_leaves = jax.tree_util.tree_leaves(capsule)
    got_leaves = bridge.tree_leaves(tcapsule)
    assert len(want_leaves) == len(got_leaves)
    for w, g in zip(want_leaves, got_leaves):
        assert g.dtype == bridge.to_torch(w).dtype
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    out = port_runtime(staleness=staleness,
                       params=bridge.policy_params_from_jax(jparams)
                       ).run_from(tcapsule, 1)
    np.testing.assert_array_equal(out.rewards, jout.rewards[2:])
    np.testing.assert_array_equal(out.dones, jout.dones[2:])
    assert int(out.state.step) == int(jout.state.step)
    for k, v in jout.params.items():
        assert np.abs(out.params[k].numpy() - np.asarray(v)).max() <= \
            PARAMS_TOL
