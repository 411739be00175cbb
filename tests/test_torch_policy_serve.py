"""Policy serving (``repro_torch.serve``): the reference's
``tests/test_serve.py``, test for test, on the port, plus parity with the
JAX ``PolicyServer``.

* A request's action is a pure function of (server seed, request seed,
  obs): the same answer, bit for bit, alone or packed, at any row of the
  fixed-shape dispatch, in any queue order, under any padding; it is one
  ``actor_forward`` row under ``request_key``.
* Against live JAX: the port's server, over a JAX policy's params
  bridged to torch, answers the JAX server's actions on fixed seeds, with
  logprobs within 1e-6 (the Gumbel noise may differ by 2 ulp, so actions
  are pinned on seeds where no tie is near).
* The service around it: the registry entry that refuses training,
  ``Session.serve`` loading any runtime's checkpoint capsule (the
  reference's files too), admission backpressure, typed shedding,
  dispatcher restarts and death, the load generator and
  ``launch.serve --spec``.

Threaded tests run under a watchdog: a hang dumps the stacks and ends
the worker after 120 s.
"""
import faulthandler
import queue
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import api as japi  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.serve import PolicyServer as JPolicyServer  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro_torch import api, bridge, envs, models  # noqa: E402
from repro_torch.core import determinism, engine  # noqa: E402
from repro_torch.core.engine import HTSConfig  # noqa: E402
from repro_torch.core.rollout import actor_forward  # noqa: E402
from repro_torch.faults import FaultPlan  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.optim import rmsprop  # noqa: E402
from repro_torch.serve import (ActionResult, DeadlineExceeded,  # noqa: E402
                               DispatcherError, Overloaded, PolicyServer,
                               ServeConfig, ServerClosed, loadgen)
from repro_torch.serve.server import obs_template  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGPROB_TOL = 1e-6


@pytest.fixture(autouse=True)
def watchdog():
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _setup(seed=3):
    env1 = envs.get_env("catch")
    cfg = HTSConfig(alpha=5, n_envs=4, seed=seed)
    policy = models.get_policy("mlp", env1)
    params = policy.init(determinism.master_key(0))
    opt = rmsprop(7e-4, eps=1e-5)
    return env1, cfg, policy.apply, params, opt


def _server(max_batch=8, max_queue=64, timeout_ms=50.0, seed=3,
            faults=None, **serve_kw):
    env1, cfg, papply, params, opt = _setup(seed)
    srv = PolicyServer(papply, params, obs_like=obs_template(env1),
                       serve=ServeConfig(max_batch=max_batch,
                                         max_queue=max_queue,
                                         timeout_ms=timeout_ms,
                                         **serve_kw),
                       seed=seed, faults=faults, device="cpu")
    return srv, env1, papply, params


def _obs(env1, n, seed=0):
    return loadgen.reset_obs(env1, n, seed)


# -------------------------------------------------------- registry entry
def test_serve_is_registered_but_not_a_training_runtime():
    assert "serve" in engine.runtime_names()
    assert "serve" not in engine.training_runtime_names()
    assert set(engine.training_runtime_names()) < set(engine.runtime_names())


def test_serve_runtime_refuses_training_loudly():
    env1, cfg, papply, params, opt = _setup()
    rt = engine.make_runtime("serve", env1, papply, params, opt, cfg,
                             device="cpu")
    for call in (lambda: rt.run(2), rt.state,
                 lambda: rt.run_from(None, 1)):
        with pytest.raises(TypeError, match="Session.serve"):
            call()


# ----------------------------------------------------------- determinism
def test_same_request_same_action_across_batch_compositions():
    """Staged on an unstarted server: the probe alone and packed with 6
    other requests answers bit-identically."""
    srv, env1, _, _ = _server(max_batch=8)
    obs = _obs(env1, 8)
    probe = (obs[0], 7)

    alone = srv.submit(*probe)
    srv.start()
    r_alone = alone.result(timeout=30)
    srv.stop()
    assert r_alone.batch_size == 1

    srv2, env1, _, _ = _server(max_batch=8)
    packed = srv2.submit(*probe)
    others = [srv2.submit(obs[i], seed=100 + i) for i in range(1, 7)]
    srv2.start()
    r_packed = packed.result(timeout=30)
    for f in others:
        f.result(timeout=30)
    srv2.stop()
    assert r_packed.batch_size == 7
    assert r_packed.action == r_alone.action
    assert r_packed.logprob == r_alone.logprob


def test_same_request_same_action_across_queue_orders():
    obs = _obs(_setup()[0], 4)
    reqs = [(obs[i], 11 * i) for i in range(4)]

    def roundtrip(order):
        srv, _, _, _ = _server(max_batch=8)
        futs = [srv.submit(*reqs[i]) for i in order]
        srv.start()
        out = {i: futs[k].result(timeout=30) for k, i in enumerate(order)}
        srv.stop()
        return out

    fwd = roundtrip([0, 1, 2, 3])
    rev = roundtrip([3, 2, 1, 0])
    for i in range(4):
        assert fwd[i].action == rev[i].action, i
        assert fwd[i].logprob == rev[i].logprob, i


def test_same_request_at_every_row_of_a_full_dispatch():
    """The probe at each of the 8 rows of a full dispatch, the other
    rows other requests: one answer, bit for bit (the CPU's form of the
    card check in chip_smoke's phase_scale)."""
    obs = _obs(_setup()[0], 8)
    probe = (obs[0], 7)
    fill = [(obs[1 + i], 100 + i) for i in range(7)]
    seen = set()
    for p in range(8):
        srv, _, _, _ = _server(max_batch=8)
        futs = [srv.submit(*r) for r in fill[:p] + [probe] + fill[p:]]
        srv.start()
        out = futs[p].result(timeout=30)
        srv.stop()
        assert out.batch_size == 8
        seen.add((out.action, out.logprob))
    assert len(seen) == 1


def test_padding_rows_cannot_leak():
    """max_batch far above the occupancy (29 zero rows) answers as a
    snug dispatch does."""
    obs = _obs(_setup()[0], 3)
    results = {}
    for B in (4, 32):
        srv, _, _, _ = _server(max_batch=B)
        futs = [srv.submit(obs[i], seed=5 + i) for i in range(3)]
        srv.start()
        results[B] = [f.result(timeout=30) for f in futs]
        srv.stop()
    for a, b in zip(results[4], results[32]):
        assert a.action == b.action
        assert a.logprob == b.logprob


def test_server_matches_direct_actor_forward():
    """The served answer is one actor_forward row under request_key, at
    the server's dispatch width."""
    srv, env1, papply, params = _server(max_batch=4, seed=3)
    obs = _obs(env1, 2)
    srv.start()
    got = [srv.act(obs[i], seed=40 + i) for i in range(2)]
    srv.stop()

    keys = determinism.request_key(determinism.master_key(3),
                                   torch.tensor([40, 41, 0, 0]))
    batch = torch.zeros((4,) + obs.shape[1:])
    batch[:2] = torch.from_numpy(obs)
    acts, logps = actor_forward(papply, params, batch, keys)
    for i in range(2):
        assert got[i].action == int(acts[i])
        assert got[i].logprob == float(logps[i])


# ------------------------------------------------------------ vs JAX
def test_actions_match_the_jax_server():
    """Same params (bridged), same obs (the envs' resets agree), same
    seeds: the JAX server's actions; logprobs within 1e-6."""
    env1 = jcatch.make()
    jparams = jmodels.get_policy("mlp", env1).init(jax.random.key(0))
    _, jobs = jax.vmap(env1.reset)(jax.random.split(jax.random.key(0), 8))
    jobs = np.asarray(jobs)
    obs = _obs(envs.get_env("catch"), 8)
    np.testing.assert_array_equal(obs, jobs)
    cfg = dict(max_batch=8, timeout_ms=20.0)
    jsrv = JPolicyServer(jmodels.get_policy("mlp", env1).apply, jparams,
                         obs_like=jobs[0], serve=JServeConfig(**cfg),
                         seed=3).start()
    tsrv = PolicyServer(models.get_policy("mlp", envs.get_env("catch")).apply,
                        bridge.policy_params_from_jax(
                            jax.tree.map(np.asarray, jparams)),
                        obs_like=obs[0], serve=ServeConfig(**cfg), seed=3,
                        device="cpu").start()
    try:
        for i in range(8):
            for seed in (0, 1, 7, 1234):
                want = jsrv.act(jobs[i], seed=seed, timeout=30)
                got = tsrv.act(obs[i], seed=seed, timeout=30)
                assert got.action == want.action, (i, seed)
                assert abs(got.logprob - want.logprob) <= LOGPROB_TOL
    finally:
        jsrv.stop()
        tsrv.stop()


# --------------------------------------------------------------- config
def test_serve_config_validates_eagerly():
    with pytest.raises(ValueError, match="max_batch"):
        ServeConfig(max_batch=0)
    with pytest.raises(ValueError, match="max_queue"):
        ServeConfig(max_queue=0)
    with pytest.raises(ValueError, match="timeout_ms"):
        ServeConfig(timeout_ms=0.0)
    with pytest.raises(ValueError):
        ServeConfig.of({"max_batch": 8, "burst": 2})   # unknown field


def test_spec_serve_block_validates_at_construction():
    with pytest.raises(ValueError, match="max_batch"):
        api.ExperimentSpec(
            env="catch", policy="mlp",
            optimizer={"name": "rmsprop", "kwargs": {"lr": 7e-4}},
            algorithm="a2c", runtime="serve",
            hts={"alpha": 4, "n_envs": 4, "seed": 0},
            serve={"max_batch": 0})


# ------------------------------------------------------------ admission
def test_overload_rejects_with_block_false():
    srv, env1, _, _ = _server(max_batch=4, max_queue=2)
    obs = _obs(env1, 1)[0]
    f1 = srv.submit(obs, seed=0, block=False)
    f2 = srv.submit(obs, seed=1, block=False)
    with pytest.raises(queue.Full):
        srv.submit(obs, seed=2, block=False)
    srv.start()
    assert isinstance(f1.result(timeout=30), ActionResult)
    assert isinstance(f2.result(timeout=30), ActionResult)
    srv.stop()
    stats = srv.stats()
    assert stats["n_rejected"] == 1 and stats["n_requests"] == 2


def test_obs_shape_mismatch_raises():
    srv, env1, _, _ = _server()
    with pytest.raises(ValueError, match="obs shape"):
        srv.submit(np.zeros((3, 3), np.float32))


def test_stopped_server_refuses_new_requests():
    srv, env1, _, _ = _server()
    obs = _obs(env1, 1)[0]
    srv.start()
    assert srv.act(obs).batch_size >= 1
    srv.stop()
    with pytest.raises(ServerClosed):
        srv.submit(obs)


# ------------------------------------------------------- fail-loud loop
def test_dispatcher_death_fails_pending_and_future_requests():
    srv, env1, _, _ = _server(max_batch=4)
    obs = _obs(env1, 1)[0]

    def boom(params, obs, seeds):
        raise RuntimeError("kaboom in dispatch")

    srv._program = boom
    fut = srv.submit(obs, seed=0)
    srv.start()
    with pytest.raises(RuntimeError, match="kaboom"):
        fut.result(timeout=30)
    srv._thread.join(timeout=30)
    assert not srv._thread.is_alive()
    assert srv.dead
    with pytest.raises(ServerClosed, match="died"):
        srv.submit(obs, seed=1)


# ------------------------------------------------- graceful degradation
def test_dispatcher_restart_keeps_health_green():
    srv, env1, _, _ = _server(max_restarts=2, restart_backoff_ms=1.0,
                              faults=FaultPlan(events=(("dispatcher", 0),)))
    obs = _obs(env1, 1)[0]
    fut = srv.submit(obs, seed=0)          # in flight at the kill
    srv.start()
    with pytest.raises(DispatcherError, match="in-place restart"):
        fut.result(timeout=30)
    out = srv.act(obs, seed=0, timeout=30)
    assert isinstance(out, ActionResult)
    h = srv.health()
    assert h["ok"] and h["ready"] and h["restarts"] == 1 and not h["dead"]
    srv.stop()


def test_restart_budget_exhaustion_kills_server():
    srv, env1, _, _ = _server(
        max_restarts=1, restart_backoff_ms=1.0,
        faults=FaultPlan(events=(("dispatcher", 0), ("dispatcher", 1))))
    obs = _obs(env1, 1)[0]
    f0 = srv.submit(obs, seed=0)
    srv.start()
    with pytest.raises(DispatcherError):
        f0.result(timeout=30)              # kill 1: absorbed in place
    f1 = srv.submit(obs, seed=1)
    with pytest.raises(RuntimeError, match="injected fault"):
        f1.result(timeout=30)              # kill 2: budget spent, dead
    srv._thread.join(timeout=30)
    assert srv.dead and not srv.health()["ok"]
    with pytest.raises(ServerClosed, match="died"):
        srv.submit(obs, seed=2)


def test_deadline_sheds_stale_queued_requests():
    srv, env1, _, _ = _server(deadline_ms=25.0)
    obs = _obs(env1, 1)[0]
    stale = srv.submit(obs, seed=0)
    time.sleep(0.2)                        # 200ms >> the 25ms deadline
    srv.start()
    with pytest.raises(DeadlineExceeded, match="deadline"):
        stale.result(timeout=30)
    assert isinstance(srv.act(obs, seed=1, timeout=30), ActionResult)
    srv.stop()
    assert srv.stats()["n_deadline"] == 1


def test_close_fails_queued_requests_with_typed_error():
    srv, env1, _, _ = _server()
    obs = _obs(env1, 1)[0]
    queued = [srv.submit(obs, seed=i) for i in range(3)]
    srv.close()                            # never started: all shed
    for f in queued:
        with pytest.raises(ServerClosed, match="closed"):
            f.result(timeout=5)
    with pytest.raises(ServerClosed):
        srv.submit(obs, seed=9)
    srv.close()                            # idempotent


def test_context_manager_closes_on_exit():
    srv, env1, _, _ = _server()
    obs = _obs(env1, 1)[0]
    with srv as s:
        assert s.ready
        assert isinstance(s.act(obs, seed=0, timeout=30), ActionResult)
    assert not srv.ready
    with pytest.raises(ServerClosed):
        srv.submit(obs, seed=1)


def test_overloaded_is_a_typed_queue_full():
    assert issubclass(Overloaded, queue.Full)
    srv, env1, _, _ = _server(max_queue=1)
    obs = _obs(env1, 1)[0]
    srv.submit(obs, seed=0, block=False)
    with pytest.raises(Overloaded, match="shed"):
        srv.submit(obs, seed=1, block=False)
    srv.close()


# -------------------------------------------------------- session.serve
def _serve_spec(ckpt_dir=None, runtime="serve", **serve_kw):
    kw = {}
    if ckpt_dir is not None:
        kw["checkpoint"] = {"dir": ckpt_dir, "every": 1}
    return api.ExperimentSpec(
        env="catch", policy="mlp",
        optimizer={"name": "rmsprop", "kwargs": {"lr": 7e-4, "eps": 1e-5}},
        algorithm="a2c", runtime=runtime,
        hts={"alpha": 4, "n_envs": 4, "seed": 3},
        serve=dict({"max_batch": 8, "timeout_ms": 50.0}, **serve_kw),
        **kw)


def test_session_serve_loads_trained_capsule(tmp_path):
    """Train under a training runtime, serve the same checkpoint dir
    under runtime='serve': the served params are the trained ones."""
    ckpt_dir = str(tmp_path / "ck")
    train = api.build(_serve_spec(ckpt_dir, runtime="mesh").replace(
        intervals=2), device="cpu")
    train.fit()
    trained = train.state().algo.params

    session = api.build(_serve_spec(ckpt_dir), device="cpu")
    srv = session.serve(start=False)
    for k in trained:
        assert torch.equal(srv.params[k], trained[k]), k
    srv.start()
    out = srv.act(_obs(session.env, 1)[0], seed=1)
    srv.stop()
    assert isinstance(out, ActionResult)


def test_session_serve_reads_a_reference_checkpoint(tmp_path):
    """A checkpoint the JAX package's trainer wrote is served by the port
    with the reference's trained params."""
    ckpt_dir = str(tmp_path / "ck")
    jsession = japi.build(japi.loads(api.dumps(
        _serve_spec(ckpt_dir, runtime="mesh").replace(intervals=2))))
    jsession.fit()
    want = jsession.state().algo.params
    srv = api.build(_serve_spec(ckpt_dir), device="cpu").serve(start=False)
    for k, v in want.items():
        np.testing.assert_array_equal(srv.params[k].numpy(), np.asarray(v))


def test_spec_serve_block_reaches_the_server():
    session = api.build(_serve_spec(max_queue=17), device="cpu")
    srv = session.serve(start=False)
    assert srv.serve.max_batch == 8
    assert srv.serve.max_queue == 17
    assert srv.serve.timeout_ms == 50.0


def test_session_serve_without_checkpoint_serves_init_params():
    session = api.build(_serve_spec(), device="cpu")
    srv = session.serve(start=False)
    for k, v in session.params.items():
        assert torch.equal(srv.params[k], v), k


def test_session_serve_works_under_training_runtimes():
    session = api.build(_serve_spec(runtime="mesh"), device="cpu")
    srv = session.serve()
    try:
        r = srv.act(_obs(session.env, 1)[0], seed=9)
        assert isinstance(r, ActionResult)
    finally:
        srv.stop()


# --------------------------------------------------------------- loadgen
def test_loadgen_smoke_returns_finite_metrics():
    metrics = loadgen.run(_serve_spec(), requests=40, rate=4000.0,
                          seed=0, warmup=8, device="cpu")
    assert set(metrics) == {"serve_qps", "serve_p50_ms", "serve_p99_ms",
                            "serve_mean_batch", "serve_shed",
                            "serve_restarts"}
    for k in ("serve_qps", "serve_p50_ms", "serve_p99_ms",
              "serve_mean_batch"):
        assert np.isfinite(metrics[k]) and metrics[k] > 0, (k, metrics[k])
    assert metrics["serve_shed"] == 0 and metrics["serve_restarts"] == 0


def test_launcher_spec_mode(capsys):
    metrics = serve_launcher.main([
        "--spec", str(ROOT / "examples/specs/quickstart.json"),
        "--requests", "40", "--rate", "4000", "--max-batch", "8",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "# serving catch x mlp (max_batch=8" in out
    assert f"serve_qps={metrics['serve_qps']:.6g}" in out
    assert metrics["serve_shed"] == 0
