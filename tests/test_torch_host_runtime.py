"""The threaded host runtime (``core/host_runtime.py``).

* Against live JAX (``HostHTSRL``) on the goldens' configuration (catch,
  mlp, rmsprop 7e-4 eps 1e-5, alpha 4, n_envs 4, seed 3), 5 intervals
  from the same params, a2c at K 1 and 2, ppo and vtrace at K 2, on both
  env backends: the reward and done streams equal, params within 1e-5.
* Within the port, with ``torch.equal``, the reference's own contracts
  (``tests/test_runtimes.py``, ``test_staleness.py``,
  ``test_perf_guards.py``): host equals mesh at K 1, 2, 4 and for runs
  shorter than K; 1, 2 or 4 actors, a rerun, a skewed step time and a
  simulated learner change no bit; run(a + b) equals run(a) and
  run_from(b) through a checkpoint at K 1, 2, 4; a host capsule
  continues on mesh and back; no caller tensor or capsule is written
  by a later segment; conflicting config forms raise; the death of an
  executor, an actor or the simulated learner raises and does not hang,
  a straggler from an earlier segment is refused, and a long segment
  keeps only the learner submissions still in flight.
* The pieces: the per-interval seed tables equal ``obs_keys`` step by
  step; a row of the actor batch does not depend on the other rows;
  ``SlabRing`` and ``device_rollout_buffer``; the live observer and the
  profile.

Every test runs under a watchdog: a hang dumps the threads' stacks and
ends the worker after 120 s instead of stalling the suite.
"""
import faulthandler
import threading
import weakref

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import models as jmodels  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.host_runtime import HostConfig as JHostConfig  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.optim import rmsprop as jrmsprop  # noqa: E402
from repro_torch import api, bridge, envs, models, optim  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core import determinism, engine, trainer  # noqa: E402
from repro_torch.core.baselines import AsyncConfig  # noqa: E402
from repro_torch.core.buffers import (SlabRing,  # noqa: E402
                                      device_rollout_buffer)
from repro_torch.core.host_runtime import HostConfig  # noqa: E402
from repro_torch.core.rollout import actor_forward  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.envs.steptime import HIGH_VAR, StepTimeModel  # noqa: E402

INTERVALS = 5
PARAMS_TOL = 1e-5
CFG = dict(alpha=4, n_envs=4, seed=3)
SKEW = dict(step_time=HIGH_VAR, time_scale=2e-3)   # mean 1, var 4


@pytest.fixture(autouse=True)
def watchdog():
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _jparams():
    return jmodels.get_policy("mlp", jcatch.make()).init(jax.random.key(0))


def make(name="host", staleness=1, algorithm="a2c", env_backend="host",
         **kw):
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    params = pol.init(determinism.master_key(0))
    if kw.pop("jax_params", False):
        params = bridge.policy_params_from_jax(
            jax.tree.map(np.asarray, _jparams()))
    cfg = engine.HTSConfig(**CFG, staleness=staleness, algorithm=algorithm,
                           env_backend=env_backend)
    return engine.make_runtime(name, env1, pol.apply, params,
                               optim.rmsprop(7e-4, eps=1e-5), cfg,
                               device="cpu", **kw)


def assert_same(a, b):
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    np.testing.assert_array_equal(a.rewards, b.rewards)
    np.testing.assert_array_equal(a.dones, b.dones)
    assert int(a.state.step) == int(b.state.step)


# ------------------------------------------------------- against JAX
@pytest.mark.parametrize("env_backend", ["host", "device"])
@pytest.mark.parametrize("algorithm,staleness", [
    ("a2c", 1), ("a2c", 2), ("ppo", 2), ("vtrace", 2)])
def test_host_matches_live_jax(algorithm, staleness, env_backend):
    env1 = jcatch.make()
    pol = jmodels.get_policy("mlp", env1)
    jout = jengine.make_runtime(
        "host", env1, pol.apply, _jparams(), jrmsprop(7e-4, eps=1e-5),
        jengine.HTSConfig(**CFG, staleness=staleness, algorithm=algorithm,
                          env_backend=env_backend),
        host=JHostConfig(n_actors=2)).run(INTERVALS)
    out = make("host", staleness, algorithm, env_backend, jax_params=True,
               n_actors=2).run(INTERVALS)
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    assert int(out.state.step) == int(jout.state.step) == INTERVALS
    for k, v in jout.params.items():
        diff = np.abs(out.params[k].numpy() - np.asarray(v)).max()
        assert diff <= PARAMS_TOL, (k, diff)


# ------------------------------------------------- host == mesh, K, n
@pytest.mark.parametrize("staleness", [1, 2, 4])
def test_host_equals_mesh(staleness):
    assert_same(make("host", staleness, n_actors=2).run(6),
                make("mesh", staleness).run(6))


def test_run_shorter_than_staleness():
    a = make("host", 4).run(2)
    assert_same(a, make("mesh", 4).run(2))
    assert int(a.state.step) == 2


def test_update_count_is_n_and_mid_stream_lags_k():
    for K in (1, 2):
        rt = make("host", K)
        assert int(rt.run(5).state.step) == 5
        assert int(rt.state().algo.step) == 5 - K


def _outstanding_bound(j: int, K: int) -> int:
    """What ``core/host_runtime.py`` guarantees outstanding at the end of
    interval j (``on_interval``), whatever the learner's speed. The
    learner runs submissions in order, and the coordinator waits at the
    start of every interval for the apply submitted in the one before
    (the ring barrier), so that apply and everything before it are done:
    only the gradient submitted after it, at the end of interval j-1,
    can still run; interval j then submits its apply (from j = K on)
    and, at its end, its gradient. Before any apply (j < K) nothing is
    waited for: the gradients of intervals 0..j. At j = K: those K, the
    first apply and gradient K."""
    if j < K:
        return j + 1
    return K + 2 if j == K else 3


@pytest.mark.parametrize("staleness", [1, 2])
def test_finished_learner_submissions_are_released(staleness):
    """A long segment keeps only the learner submissions in flight: at
    each interval's end no more than the ring barrier leaves outstanding
    (``_outstanding_bound``), and alive besides them only the K pending
    gradients' handles, the last apply and the gradient it consumes;
    none once the segment ends. A finished submission holds a gradient
    tree or a whole ``DelayedGradState``, so keeping them all grows
    without bound."""
    rt = make("host", staleness)
    made, seen = [], []
    submit = rt._submit

    def tracked(fn, *args):
        h = submit(fn, *args)
        made.append(weakref.ref(h))
        return h

    rt._submit = tracked
    rt.on_interval = lambda j, m: seen.append(
        (j, len(rt._handles), sum(r() is not None for r in made)))
    n = 50
    rt.run(n)
    assert len(made) == 2 * n - staleness
    assert all(out <= _outstanding_bound(j, staleness)
               for j, out, _ in seen), seen
    assert max(alive for _, _, alive in seen) <= staleness + 2, seen
    assert not rt._handles


def test_actor_counts_and_reruns_give_the_same_bits():
    """Paper Tab. 4: the actor count changes the batches, not a bit."""
    outs = [make(n_actors=n).run(3) for n in (1, 2, 4)]
    rt = make(n_actors=2)
    outs += [rt.run(3), rt.run(3)]
    for o in outs[1:]:
        assert_same(outs[0], o)


def test_skewed_step_time_and_sim_learner_give_the_same_bits():
    """High-variance step times reorder which envs share a batch, and a
    simulated learner delays the applies: neither changes the result."""
    mesh = make("mesh", 2).run(4)
    assert_same(make("host", 2, host=HostConfig(n_actors=2, **SKEW))
                .run(4), mesh)
    assert_same(make("host", 2, learner_time=0.01).run(4), mesh)


def test_skewed_capsule_continues_on_mesh(tmp_path):
    straight = make("mesh").run(4)
    a = make("host", host=HostConfig(n_actors=2, **SKEW))
    a.run(2)
    path = str(tmp_path / "skewed")
    ckpt_io.save(path, trainer.to_disk(a.state()))
    b = make("mesh")
    out = b.run_from(trainer.restore_capsule(path, b.state()), 2)
    assert all(torch.equal(straight.params[k], out.params[k])
               for k in out.params)


# ------------------------------------------------------- continuation
@pytest.mark.parametrize("staleness", [1, 2, 4])
def test_run_from_through_checkpoints_equals_run(tmp_path, staleness):
    """run(5) == run_from segments of 2 and 3 with a disk checkpoint
    round trip at each boundary: the capsule carries the ring and the
    in-flight gradients are re-dispatched."""
    straight = make("host", staleness).run(5)
    rt = make("host", staleness)
    template = rt.state()
    state, rewards = template, []
    for i, n in enumerate((2, 3)):
        out = rt.run_from(state, n)
        rewards.append(out.rewards)
        path = str(tmp_path / f"boundary_{i}")
        ckpt_io.save(path, trainer.to_disk(rt.state()))
        state = trainer.restore_capsule(path, template)
    assert all(torch.equal(straight.params[k], out.params[k])
               for k in out.params)
    np.testing.assert_array_equal(straight.rewards, np.concatenate(rewards))
    assert int(rt.run_from(rt.state(), 0).state.step) == 5


def test_capsule_crosses_to_mesh_and_back():
    """At K=2: host 3 intervals, mesh 2 more, host 1 more == mesh 6."""
    straight = make("mesh", 2).run(6)
    a = make("host", 2)
    a.run(3)
    b = make("mesh", 2)
    b.run_from(a.state(), 2, finalize=False)
    out = a.run_from(b.state(), 1)
    assert int(out.state.step) == int(straight.state.step)
    assert all(torch.equal(straight.params[k], out.params[k])
               for k in out.params)


def test_state_before_run_and_zero_interval_segment():
    rt = make("host", 2)
    s = rt.state()
    assert int(s.interval) == 0 and s.buffer["obs"].shape[0] == 2
    out = rt.run_from(s, 0)
    assert out.rewards.shape == (0, CFG["alpha"], CFG["n_envs"])
    assert all(torch.equal(out.params[k], rt.params0[k])
               for k in rt.params0)


def test_no_caller_tensor_or_capsule_is_written_later():
    """Mirror of test_perf_guards' donation guard for every ported
    training runtime: the caller's params survive runs, and a captured
    capsule is unchanged after further segments."""
    for name in ("host", "mesh", "sync", "async"):
        kw = ({"acfg": AsyncConfig(staleness=2)} if name == "async"
              else {})
        rt = make(name, **kw)
        before = [p.clone() for p in tree_leaves(rt.params0)]
        rt.run(2)
        s = rt.state()
        snap = [x.clone() for x in tree_leaves(s)]
        rt.run_from(s, 1)
        rt.run(2)
        assert all(torch.equal(a, b) for a, b in zip(snap, tree_leaves(s))), \
            name
        assert all(torch.equal(a, b)
                   for a, b in zip(before, tree_leaves(rt.params0))), name


# ------------------------------------------------------------ guards
def test_conflicting_config_forms_and_staleness_raise():
    with pytest.raises(TypeError, match="n_actors"):
        make(host=HostConfig(n_actors=2), n_actors=8)
    assert make(host=HostConfig(n_actors=2)).host.n_actors == 2
    assert make(n_actors=3).host.n_actors == 3
    with pytest.raises(ValueError, match="staleness"):
        make("host", 0)


class _BombTime(StepTimeModel):
    """A duration model that raises in a worker thread at (id, index):
    as step_time it kills an executor, as learner_time the sim learner."""

    def __init__(self, env_id, step):
        super().__init__()
        object.__setattr__(self, "env_id", env_id)
        object.__setattr__(self, "step", step)

    def sample(self, env_id, step, seed=0):
        if env_id == self.env_id and step >= self.step:
            raise RuntimeError("boom: simulated env failure")
        return 0.0


def test_executor_death_raises_instead_of_hanging():
    rt = make(host=HostConfig(n_actors=2, step_time=_BombTime(2, 7)))
    with pytest.raises(RuntimeError) as ei:
        rt.run(4)
    msg = str(ei.value)
    assert "worker thread died" in msg
    assert "boom: simulated env failure" in msg
    assert "worker thread traceback" in msg


def test_actor_death_raises_and_the_runtime_recovers():
    rt = make(n_actors=2)
    rt.init()
    real, calls = rt._actor_fwd, []

    def dying(*a, **k):
        calls.append(1)
        if len(calls) > 3:
            raise ValueError("actor fwd blew up")
        return real(*a, **k)

    rt._actor_fwd = dying
    with pytest.raises(RuntimeError, match="actor fwd blew up"):
        rt.run(4)
    rt._actor_fwd = real
    assert rt.run(2).steps == 2 * CFG["alpha"] * CFG["n_envs"]
    assert not any(th.is_alive() for th in rt._zombies)


def test_sim_learner_death_raises_instead_of_hanging():
    rt = make(host=HostConfig(n_actors=2, learner_time=_BombTime(0, 2)))
    with pytest.raises(RuntimeError, match="boom: simulated env failure"):
        rt.run(5)


def test_a_straggler_from_an_earlier_segment_is_refused():
    rt = make()
    release = threading.Event()
    straggler = threading.Thread(target=release.wait, daemon=True)
    straggler.start()
    rt._zombies = [straggler]
    try:
        with pytest.raises(RuntimeError, match="still running"):
            rt.run(1)
    finally:
        release.set()
        straggler.join(timeout=10)
    assert rt.run(1).steps == CFG["alpha"] * CFG["n_envs"]


# ------------------------------------------------------------ pieces
def test_seed_tables_equal_obs_keys():
    rt = make()
    rt._build()
    master = determinism.master_key(CFG["seed"])
    ids = torch.arange(CFG["n_envs"])
    for j in (0, 3):
        acts, steps = rt._tables_fn(j)
        for t in range(CFG["alpha"]):
            g = j * CFG["alpha"] + t
            assert torch.equal(acts[t], determinism.obs_keys(master, ids, g))
            assert torch.equal(steps[t], determinism.obs_keys(
                master, ids + 1_000_003, g))


def test_actor_rows_do_not_depend_on_other_rows():
    """The property the fixed-row batches rely on: a row's action and
    logprob are the same bits whatever the other rows hold."""
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    params = pol.init(determinism.master_key(0))
    gen = torch.Generator().manual_seed(0)
    n = 16
    keys = determinism.obs_keys(determinism.master_key(1), torch.arange(n), 5)
    obs = torch.rand((n,) + env1.obs_shape, generator=gen)
    a0, b0 = actor_forward(pol.apply, params, obs, keys)
    for _ in range(3):
        other = torch.rand((n,) + env1.obs_shape, generator=gen)
        mask = torch.rand(n, generator=gen) < 0.5
        mixed = torch.where(
            mask.reshape((n,) + (1,) * len(env1.obs_shape)), obs, other)
        a, b = actor_forward(pol.apply, params, mixed, keys)
        assert torch.equal(a[mask], a0[mask])
        assert torch.equal(b[mask], b0[mask])


def test_slab_ring_and_rollout_buffer():
    spec = {"obs": ((3,), np.float32), "actions": ((), np.int32)}
    with pytest.raises(ValueError, match="2 slots"):
        SlabRing(2, 4, spec, n_slots=1)
    ring = SlabRing(2, 4, spec, n_slots=3)
    slab, boot = ring.write_view(4)
    slab["obs"][1, 2] = 7.0
    boot[3] = 5.0
    traj = ring.as_traj(1)            # slot 1 == interval 4's
    assert traj["obs"][1, 2, 0] == 7.0 and traj["bootstrap_obs"][3, 1] == 5
    assert traj["actions"].dtype == torch.int32
    assert ring.as_traj(2)["obs"].abs().sum() == 0
    slab["obs"][0, 0] = 1.0           # by reference on the CPU
    assert traj["obs"][0, 0, 0] == 1.0
    buf = device_rollout_buffer(4, 2, (3,), torch.float32)
    assert buf["obs"].shape == (2, 4, 3) and bool((buf["dones"] == 1).all())
    assert buf["bootstrap_obs"].shape == (4, 3)


def test_live_observer_and_profile():
    """A Session over the host runtime calls its observers from the
    coordinator while the run goes on, with the streams the RunResult
    reports; a mesh Session calls them after the run with the same
    payloads. ``profile`` splits the wall time by phase."""
    spec = api.ExperimentSpec(env="catch", hts=dict(CFG), runtime={
        "name": "host", "kwargs": {"host": {"n_actors": 2,
                                            "profile": True}}})
    session = api.build(spec, device="cpu")
    assert session.runtime.host == HostConfig(n_actors=2, profile=True)
    seen = []
    session.on_interval(lambda m: seen.append(
        (m["interval"], m["rewards"].copy(), threading.current_thread())))
    out = session.run(3)
    assert [s[0] for s in seen] == [0, 1, 2]
    assert all(th is threading.main_thread() for *_, th in seen)
    np.testing.assert_array_equal(np.stack([s[1] for s in seen]),
                                  out.rewards)
    assert session.runtime.on_interval is None
    assert {"actor_forward", "env_step_dispatch", "actor_wait",
            "env_step_wait", "interval_barrier", "learner_grad",
            "learner_apply"} <= set(session.runtime.profile)
    mesh = api.build(spec.replace(runtime="mesh"), device="cpu")
    post = []
    mesh.on_interval(lambda m: post.append(m["rewards"]))
    mesh.run(3)
    np.testing.assert_array_equal(np.stack(post), out.rewards)
