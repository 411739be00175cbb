"""Multi-tenant pools (``repro_torch.tenancy``): the reference's
``tests/test_tenancy.py``, test for test, on the port, plus parity with
the JAX ``TenantPool``.

* The stride schedule is a pure function of (admission order, weights,
  quanta, budgets): two pools emit one grant trace, grants split by
  weight, and the trace equals the JAX pool's over the same specs.
* Multiplexing is invisible: every tenant of a heterogeneous pool
  (envs, algorithms, staleness, runtimes, weights), through a mid-pool
  evict and readmit and one tenant's injected faults, ends with params
  and reward/episode streams equal to its solo ``run`` bit for bit, at
  any ``max_concurrency``.
* Multi-model serving answers each (model, obs, seed) request as that
  model's own server does, whatever else shares the dispatch.
* Sessions built one after another in one process share nothing; pool
  checkpoints are the trainer's; ``launch.pool --check-solo`` passes.

Threaded tests run under a watchdog: a hang dumps the stacks and ends
the worker after 120 s.
"""
import dataclasses
import faulthandler
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro.launch import pool as jpool_launcher  # noqa: E402
from repro.tenancy import TenantPool as JTenantPool  # noqa: E402
from repro_torch import api, bridge  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core import evaluate  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from repro_torch.launch import pool as pool_launcher  # noqa: E402
from repro_torch.serve import PolicyServer, ServeConfig  # noqa: E402
from repro_torch.serve.loadgen import reset_obs  # noqa: E402
from repro_torch.tenancy import (TenancyConfig, TenantPool,  # noqa: E402
                                 capsule_params)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def watchdog():
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


# ------------------------------------------------------------- helpers
def _spec_dict(env="catch", algorithm="a2c", seed=3, intervals=3,
               runtime="host", weight=1, quantum=1, name=None, staleness=1,
               env_kwargs=None, faults=None):
    """A tiny tenant spec: alpha 3 x 4 envs keeps every slice cheap."""
    d = {
        "env": {"name": env, "kwargs": env_kwargs or {}},
        "algorithm": algorithm,
        "runtime": runtime,
        "hts": {"alpha": 3, "n_envs": 4, "seed": seed,
                "staleness": staleness},
        "intervals": intervals,
        "tenancy": {"weight": weight, "quantum": quantum, "name": name},
    }
    if faults is not None:
        d["faults"] = faults
    return d


def _spec(**kw):
    return api.from_dict(_spec_dict(**kw))


def _pool(specs, **kw):
    return TenantPool(specs, device="cpu", **kw)


def _build(spec):
    return api.build(spec, device="cpu")


def _solo(spec):
    """The oracle: a fresh solo run (faults stripped: the recovery
    guarantee says supervised results equal the fault-free run's)."""
    out = _build(dataclasses.replace(spec, faults=FaultPlan())) \
        .run(spec.intervals)
    stream = evaluate.ReturnStream(spec.hts.get("n_envs", 4))
    stream.extend(out.rewards, out.dones)
    return out, stream.returns


def _params_equal(a, b) -> bool:
    return all(torch.equal(a[k], b[k]) for k in b)


def _assert_tenant_equals_solo(res, spec):
    out, solo_returns = _solo(spec)
    assert res.status == "done"
    assert res.intervals == spec.intervals
    assert _params_equal(res.params, out.params)
    np.testing.assert_array_equal(res.rewards, out.rewards)
    np.testing.assert_array_equal(res.dones, out.dones)
    np.testing.assert_array_equal(res.episode_returns, solo_returns)


# -------------------------------------------------------------- config
def test_tenancy_config_validation():
    assert TenancyConfig().is_default
    assert TenancyConfig.of(None).is_default
    assert TenancyConfig.of({"weight": 3}).weight == 3
    assert TenancyConfig.of({"weight": 2, "quantum": 4, "name": "x"}) \
        .canonical() == {"weight": 2, "quantum": 4, "name": "x"}
    for bad in ({"weight": 0}, {"quantum": 0}, {"weight": -1},
                {"nope": 1}, {"name": ""}):
        with pytest.raises((ValueError, TypeError)):
            TenancyConfig.of(bad)


def test_spec_carries_tenancy_but_fingerprint_ignores_it():
    a = _spec(weight=1, quantum=1)
    b = _spec(weight=5, quantum=2, name="vip")
    assert a.tenancy.weight == 1 and b.tenancy.name == "vip"
    assert api.loads(api.dumps(b)).tenancy == b.tenancy
    assert api.workload_fingerprint(a) == api.workload_fingerprint(b)


# ----------------------------------------------------------- scheduler
def _schedule_only(pool):
    # the schedule never reads execution results: driving _next/_grant
    # alone gives the run's grant order
    while True:
        t = pool._next()
        if t is None:
            return list(pool.trace)
        pool._grant(t)


def _weighted_dicts():
    return [_spec_dict(seed=3, intervals=6, weight=3, name="w3"),
            _spec_dict(seed=4, intervals=6, weight=2, name="w2"),
            _spec_dict(seed=5, intervals=6, weight=1, name="w1")]


def test_stride_schedule_is_deterministic_and_weighted():
    p1 = _pool([api.from_dict(d) for d in _weighted_dicts()])
    p2 = _pool([api.from_dict(d) for d in _weighted_dicts()])
    tr1, tr2 = _schedule_only(p1), _schedule_only(p2)
    assert tr1 == tr2
    assert [n for n, _, _ in tr1[:3]] == ["w3", "w2", "w1"]
    counts = {"w3": 0, "w2": 0, "w1": 0}
    for name, _, n in tr1[:6]:
        counts[name] += n
    assert counts == {"w3": 3, "w2": 2, "w1": 1}
    assert p1.schedule_counts() == {"w3": 6, "w2": 6, "w1": 6}
    assert all(isinstance(t.passv, Fraction)
               for t in p1._tenants.values())


def test_schedule_equals_the_jax_pool():
    """Same specs, weights and quanta: the port's grant trace is the JAX
    pool's, grant for grant."""
    dicts = _weighted_dicts() + [_spec_dict(seed=6, intervals=5, weight=2,
                                            quantum=2, name="q2")]
    port = _schedule_only(_pool([api.from_dict(d) for d in dicts]))
    ref = _schedule_only(JTenantPool([japi.from_dict(d) for d in dicts]))
    assert port == ref


def test_quantum_slices_and_tail_grant():
    pool = _pool([_spec(intervals=6, quantum=4, name="t")])
    while pool._next() is not None:
        pool._grant(pool._next())
    assert pool.trace == [("t", 0, 4), ("t", 4, 2)]


# ----------------------------------------------- pool vs solo (flagship)
def test_heterogeneous_pool_bit_exact_to_solo_with_chaos():
    """Three tenants (catch/a2c/mesh, seeded-gridmaze/ppo/K=2/mesh,
    catch/a2c/host), distinct weights and quanta, overlapped slices, a
    mid-pool evict + readmit of the maze tenant and two injected faults
    confined to the host tenant: every tenant equals its solo run bit
    for bit; the faults fire and stay in their domain."""
    spec_a = _spec(env="catch", algorithm="a2c", runtime="mesh", seed=5,
                   intervals=4, weight=3, quantum=2, name="catch-mesh")
    spec_b = _spec(env="gridmaze", env_kwargs={"scenario_seed": 7},
                   algorithm="ppo", runtime="mesh", seed=9, staleness=2,
                   intervals=3, weight=1, quantum=1, name="maze")
    spec_c = _spec(env="catch", algorithm="a2c", runtime="host", seed=2,
                   intervals=4, weight=2, quantum=2, name="stormy",
                   faults={"events": [["stepper", 1], ["executor", 2]],
                           "max_restarts": 3, "backoff": 0.01})

    phase = {"evicted": False, "readmitted": False}

    def chaos(name, done, _out):
        if name == "maze" and done == 1 and not phase["evicted"]:
            partial = pool.evict("maze")
            assert partial.status == "evicted"
            assert partial.intervals >= 1
            phase["evicted"] = True
        elif phase["evicted"] and not phase["readmitted"] \
                and name != "maze":
            pool.readmit("maze")
            phase["readmitted"] = True

    pool = _pool([spec_a, spec_b, spec_c], max_concurrency=2,
                 on_slice=chaos)
    results = pool.run()

    assert phase == {"evicted": True, "readmitted": True}
    assert set(results) == {"catch-mesh", "maze", "stormy"}
    assert results["stormy"].restarts >= 2
    assert results["catch-mesh"].restarts == 0
    assert results["maze"].restarts == 0
    for spec in (spec_a, spec_b, spec_c):
        _assert_tenant_equals_solo(results[spec.tenancy.name], spec)


@pytest.mark.parametrize("max_concurrency", [1, 3])
def test_max_concurrency_changes_wallclock_only(max_concurrency):
    specs = [_spec(seed=11, intervals=3, name="p", runtime="mesh"),
             _spec(seed=12, intervals=3, weight=2, name="q")]
    pool = _pool(specs, max_concurrency=max_concurrency)
    res = pool.run()
    assert pool.trace == _schedule_only(_pool(specs))
    for spec in specs:
        _assert_tenant_equals_solo(res[spec.tenancy.name], spec)


def test_pool_step_microscope_and_late_admission():
    pool = _pool([_spec(seed=21, intervals=2, name="early")])
    assert pool.step()
    late_spec = _spec(seed=22, intervals=2, name="late")
    pool.admit(late_spec)
    assert pool._get("late").passv == pool._get("early").passv
    assert isinstance(pool._get("late").passv, Fraction)
    while pool.step():
        pass
    results = pool.results()
    assert results["early"].status == "done"
    _assert_tenant_equals_solo(results["late"], late_spec)


# ------------------------------------------------------------ lifecycle
def test_lifecycle_state_machine_is_loud():
    pool = _pool([_spec(name="a", runtime="mesh"),
                  _spec(seed=4, name="b", runtime="mesh")])
    with pytest.raises(ValueError, match="already admitted"):
        pool.admit(_spec(seed=5, name="a"))
    with pytest.raises(KeyError, match="no tenant"):
        pool.pause("ghost")
    pool.pause("a")
    with pytest.raises(ValueError, match="cannot pause"):
        pool.pause("a")
    with pytest.raises(ValueError, match="cannot readmit"):
        pool.readmit("a")
    pool.resume("a")
    with pytest.raises(ValueError, match="cannot resume"):
        pool.resume("a")
    pool.evict("b")
    assert pool.status("b") == "evicted"
    pool.readmit("b")
    results = pool.run()
    assert all(r.status == "done" for r in results.values())
    with pytest.raises(ValueError, match="already completed"):
        pool.evict("a")


def test_paused_tenant_gets_no_grants_and_reports_partial():
    pool = _pool([_spec(seed=6, intervals=2, name="run", runtime="mesh"),
                  _spec(seed=7, intervals=2, name="hold")],
                 max_concurrency=1)
    pool.pause("hold")
    results = pool.run()
    assert results["run"].status == "done"
    assert results["hold"].status == "paused"
    assert results["hold"].intervals == 0
    assert results["hold"].params is None
    assert pool.schedule_counts() == {"run": 2, "hold": 0}


def test_pool_constructor_validation():
    with pytest.raises(ValueError, match="max_concurrency"):
        _pool([], max_concurrency=0)
    with pytest.raises(ValueError, match="align"):
        _pool([_spec()], weights=[1, 2])


def test_session_pool_builds_a_tenant_pool():
    pool = api.Session.pool([_spec(name="s", runtime="mesh")],
                            max_concurrency=1, device="cpu")
    assert isinstance(pool, TenantPool) and pool.tenants() == ["s"]
    assert pool.run()["s"].status == "done"


# ------------------------------------------------------- multi-model serve
def _probe_obs(session, n, seed=0):
    return reset_obs(session.env, n, seed)


def _server(session, obs_like, cfg, **kw):
    return PolicyServer(session.policy.apply, session.params,
                        obs_like=obs_like, serve=cfg, seed=session.cfg.seed,
                        device="cpu", **kw)


def test_multi_model_answers_match_single_model_servers():
    sa = _build(_spec(env="catch", seed=5, name="ma"))
    sb = _build(_spec(env="gridmaze", seed=9, name="mb",
                      env_kwargs={"scenario_seed": 7}))
    cfg = ServeConfig(max_batch=8, timeout_ms=20.0)
    obs_a, obs_b = _probe_obs(sa, 4), _probe_obs(sb, 4, seed=1)

    def single(session, obs, seed):
        srv = _server(session, obs[0], cfg).start()
        try:
            return srv.act(obs[0], seed=seed)
        finally:
            srv.stop()

    ref_a = single(sa, obs_a, seed=7)
    ref_b = single(sb, obs_b, seed=13)

    multi = _server(sa, obs_a[0], cfg, model="ma")
    multi.add_model("mb", sb.policy.apply, sb.params,
                    obs_like=obs_b[0], seed=sb.cfg.seed)
    fa = multi.submit(obs_a[0], seed=7, model="ma")
    fb = multi.submit(obs_b[0], seed=13, model="mb")
    fillers = [multi.submit(obs_a[i], seed=100 + i, model="ma")
               for i in range(1, 4)]
    fillers += [multi.submit(obs_b[i], seed=200 + i, model="mb")
                for i in range(1, 4)]
    multi.start()
    got_a, got_b = fa.result(timeout=30), fb.result(timeout=30)
    for f in fillers:
        f.result(timeout=30)
    multi.stop()

    assert (got_a.action, got_a.logprob) == (ref_a.action, ref_a.logprob)
    assert (got_b.action, got_b.logprob) == (ref_b.action, ref_b.logprob)
    stats = multi.stats()
    assert set(stats["models"]) == {"ma", "mb"}
    assert stats["models"]["ma"]["n_requests"] == 4
    assert stats["models"]["mb"]["n_requests"] == 4


def test_multi_model_unknown_model_and_shape_are_loud():
    sa = _build(_spec(env="catch", seed=5))
    obs = _probe_obs(sa, 1)
    srv = _server(sa, obs[0], ServeConfig(max_batch=4), model="only")
    with pytest.raises(KeyError, match="only"):
        srv.submit(obs[0], model="ghost")
    with pytest.raises(ValueError, match="already"):
        srv.add_model("only", sa.policy.apply, sa.params, obs_like=obs[0])
    with pytest.raises(ValueError):
        srv.submit(np.zeros((3, 3), np.float32), model="only")


def test_pool_serve_routes_every_tenant():
    pool = _pool([_spec(env="catch", seed=5, name="ta"),
                  _spec(env="gridmaze", seed=9, name="tb",
                        env_kwargs={"scenario_seed": 7})],
                 max_concurrency=1)
    results = pool.run()
    server = pool.serve()
    try:
        sa = pool._get("ta").session
        obs = _probe_obs(sa, 1)
        got = server.act(obs[0], seed=17, model="ta")
        solo = PolicyServer(sa.policy.apply, results["ta"].params,
                            obs_like=obs[0], serve=sa.spec.serve,
                            seed=sa.cfg.seed, device="cpu").start()
        try:
            ref = solo.act(obs[0], seed=17)
        finally:
            solo.stop()
        assert (got.action, got.logprob) == (ref.action, ref.logprob)
        assert sorted(server.models()) == ["ta", "tb"]
    finally:
        server.stop()
    with pytest.raises(ValueError, match="empty pool"):
        TenantPool().serve()


def test_capsule_params_prefix_and_shape_check():
    s = _build(_spec(seed=5, runtime="mesh"))
    state = s.state()
    p = capsule_params(state, s.params)
    assert _params_equal(p, s.params)
    bad = {k: torch.zeros(tuple(v.shape) + (2,)) for k, v in s.params.items()}
    with pytest.raises(ValueError, match="shape"):
        capsule_params(state, bad)


# -------------------------------------------- isolation baseline (solo)
def test_sequential_sessions_share_nothing():
    spec_a = _spec(env="catch", seed=31, intervals=2)
    spec_b = _spec(env="gridmaze", algorithm="ppo", seed=32, intervals=2,
                   env_kwargs={"scenario_seed": 7})

    first = _build(spec_a)
    heard_a = []
    first.on_interval(lambda m: heard_a.append(m["interval"]))
    out_a1 = first.run(2)
    assert heard_a == [0, 1]

    other = _build(spec_b)
    out_b = other.run(2)
    assert heard_a == [0, 1]
    assert other._observers == []

    # a spec with a fault plan builds its own injector; building it arms
    # nothing process-wide
    _build(_spec(seed=33, faults={"events": [["stepper", 0]],
                                  "max_restarts": 1}))

    again = _build(spec_a)
    out_a2 = again.run(2)           # would raise if the injector leaked
    assert _params_equal(out_a1.params, out_a2.params)
    np.testing.assert_array_equal(out_a1.rewards, out_a2.rewards)
    assert not np.array_equal(out_a1.rewards, out_b.rewards)


def test_pool_checkpoints_are_trainer_compatible(tmp_path):
    spec = dataclasses.replace(
        _spec(seed=41, intervals=2, name="ck", runtime="mesh"),
        checkpoint={"dir": str(tmp_path / "ck"), "every": 1, "keep": 2})
    results = _pool([spec], max_concurrency=1).run()
    latest = ckpt_io.latest(str(tmp_path / "ck"))
    assert latest is not None and latest.endswith("step_00000002")
    session = _build(spec)
    restored = bridge.policy_params_from_jax(ckpt_io.restore_prefix(
        latest, bridge.policy_params_to_reference(session.params)))
    assert _params_equal(restored,
                         capsule_params(results["ck"].state, session.params))
    # and a port session resumes the pool's checkpoint as the trainer's
    out = _build(dataclasses.replace(spec, checkpoint={
        "dir": str(tmp_path / "ck"), "every": 1, "keep": 2})).fit(
            3, resume=True)
    solo = _build(spec.replace(checkpoint={"dir": None})).fit(3)
    assert _params_equal(out.params, solo.params)


# ---------------------------------------------------------------- CLI
def test_launcher_check_solo_and_digests(capsys):
    results = pool_launcher.main([
        "--spec", str(ROOT / "examples/specs/pool_a.json"),
        "--spec", str(ROOT / "examples/specs/pool_b.json"),
        "--intervals", "3", "--digest", "--check-solo", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[pool] every tenant bit-exact to its solo run" in out
    assert set(results) == {"catch-a2c", "maze-ppo"}
    for name, r in results.items():
        d = pool_launcher.result_digest(r.params, r.rewards,
                                        r.episode_returns)
        assert f"digest {name} {d}" in out


def test_launcher_helpers_equal_the_reference():
    shares = [3.0, 1.5, 6.0]
    assert pool_launcher.jain_index(shares) == \
        jpool_launcher.jain_index(shares)
    assert np.isnan(pool_launcher.jain_index([]))
    params = {"b": torch.arange(3, dtype=torch.float32),
              "a": torch.ones(2, 2)}
    rewards, rets = np.ones((2, 3, 4), np.float32), np.arange(3.0)
    assert pool_launcher.result_digest(params, rewards, rets) == \
        jpool_launcher.result_digest(
            {k: v.numpy() for k, v in params.items()}, rewards, rets)
