"""Fault injection at the host runtime's own sites, under the trainer's
supervision: the reference's recovery contract (``tests/test_faults.py``)
held within the port with ``torch.equal``.

A supervised fit of the ``host`` runtime (catch, mlp, rmsprop, alpha 4,
n_envs 4, seed 3, 6 intervals, a checkpoint every 2) under a fault plan
ends with the params, the episode-return stream and the reward stream of
the fault-free fit, for a death at each worker site (``actor``,
``executor``, ``stepper``), an env exception (``env_step``) and a
learner death or NaN update (``learner`` exc, nan), past a corrupt
checkpoint, and from a JSON spec through ``api.build``, whose one
injector spans the runtime's pools and the trainer. A persistent fault
exhausts ``max_restarts``; an unsupervised one propagates; an empty plan
builds no injector.

Every test runs under a watchdog: a hang dumps the threads' stacks and
ends the worker after 120 s instead of stalling the suite.
"""
import faulthandler

import numpy as np
import pytest
import torch

from repro_torch import api, envs, models, optim
from repro_torch.core import determinism, engine
from repro_torch.core.trainer import Trainer
from repro_torch.core.tree import tree_leaves
from repro_torch.faults import FaultInjector, FaultPlan

N = 6          # intervals per fit
EVERY = 2      # checkpoint cadence
CFG = dict(alpha=4, n_envs=4, seed=3)


@pytest.fixture(autouse=True)
def watchdog():
    faulthandler.dump_traceback_later(120, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()


def _host(faults=None):
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    return engine.make_runtime(
        "host", env1, pol.apply, pol.init(determinism.master_key(0)),
        optim.rmsprop(7e-4, eps=1e-5), engine.HTSConfig(**CFG),
        device="cpu", faults=faults, n_actors=2)


def _fit(ckpt_dir, injector=None):
    """One supervised host fit; the runtime and the trainer share the
    injector, as ``api.build`` threads one through a Session."""
    return Trainer(_host(injector), checkpoint_dir=str(ckpt_dir),
                   ckpt_every=EVERY, faults=injector).fit(N)


def _assert_bitexact(got, want):
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k
    for a, b in zip(tree_leaves(got.state), tree_leaves(want.state)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got.episode_returns, want.episode_returns)
    np.testing.assert_array_equal(got.rewards, want.rewards)


def _plan(*events, max_restarts=2):
    return FaultInjector(FaultPlan(events=events, max_restarts=max_restarts,
                                   backoff=0.0, backoff_cap=0.0))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The fault-free fit every recovery is held against."""
    return _fit(tmp_path_factory.mktemp("ref") / "ck")


@pytest.mark.parametrize("site,kind", [
    ("actor", ""), ("executor", ""), ("stepper", ""),
    ("env_step", ""), ("learner", "exc"), ("learner", "nan"),
])
def test_recovery_is_bitexact_per_site(tmp_path, reference, site, kind):
    """Interval 2 opens the second segment, so the restore is from a
    real mid-run checkpoint; a NaN update is applied at interval 3 and
    caught by the finite check before that segment's checkpoint."""
    inj = _plan((site, 2, kind))
    rep = _fit(tmp_path / "ck", inj)
    assert rep.restarts == 1 and not inj.armed
    rec = rep.recoveries[0]
    assert set(rec) == {"failure", "restored_to", "backoff_s", "restore_s"}
    assert rec["restored_to"] == 2 and rec["restore_s"] >= 0.0
    if kind == "nan":
        assert "LearnerDiverged" in rec["failure"]
    else:
        assert "injected fault" in rec["failure"]
    _assert_bitexact(rep, reference)


def test_corrupt_checkpoint_fallback_is_bitexact(tmp_path, reference):
    """The checkpoint at 4 truncated, then a stepper death at 5: the walk
    skips step 4 and restores step 2."""
    rep = _fit(tmp_path / "ck", _plan(("checkpoint", 4, "truncate"),
                                      ("stepper", 5)))
    assert rep.restarts == 1
    assert rep.recoveries[0]["restored_to"] == 2
    _assert_bitexact(rep, reference)


def test_restart_budget_exhausted_reraises(tmp_path):
    with pytest.raises(RuntimeError, match="injected fault"):
        _fit(tmp_path / "ck", _plan(("stepper", 2), ("stepper", 2),
                                    max_restarts=1))


def test_unsupervised_failure_propagates(tmp_path):
    with pytest.raises(RuntimeError, match="injected fault"):
        _fit(tmp_path / "ck", FaultInjector(FaultPlan(
            events=(("executor", 1),))))


def _spec(tmp_path, tag, faults):
    return api.ExperimentSpec(
        env="catch", policy="mlp",
        optimizer={"name": "rmsprop", "kwargs": {"lr": 7e-4}},
        algorithm="a2c", runtime={"name": "host",
                                  "kwargs": {"host": {"n_actors": 2}}},
        hts=dict(CFG), intervals=N,
        checkpoint={"dir": str(tmp_path / tag), "every": 1}, faults=faults)


def test_spec_driven_chaos_is_bitexact(tmp_path):
    """A JSON-round-tripped spec with a stepper death, a truncated
    checkpoint and an executor death whose recovery falls back past the
    corrupt capsule, built by ``api.build`` (one injector for the pools
    and the trainer), ends equal to the same spec without faults."""
    chaos = _spec(tmp_path, "chaos", {
        "events": [{"site": "stepper", "interval": 2},
                   {"site": "checkpoint", "interval": 3,
                    "kind": "truncate"},
                   {"site": "executor", "interval": 3}],
        "max_restarts": 3, "backoff": 0.0, "backoff_cap": 0.0})
    chaos = api.loads(api.dumps(chaos))
    session = api.build(chaos, device="cpu")
    assert session.runtime._faults is session.faults
    rep = session.fit()
    clean = api.build(_spec(tmp_path, "clean", {}), device="cpu").fit()
    assert rep.restarts == 2
    assert rep.recoveries[1]["restored_to"] == 2
    _assert_bitexact(rep, clean)


def test_trivial_plan_adds_no_machinery(tmp_path):
    session = api.build(_spec(tmp_path, "none", {}), device="cpu")
    assert session.faults is None
    assert session.runtime._faults is None
