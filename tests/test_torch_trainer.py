"""The port's checkpointed trainer: resume, recovery, divergence.

* ``fit(40)`` equals ``fit(20)`` followed by a fresh ``Trainer`` (fresh
  runtime) resuming to 40: the capsule, the reported params and the
  episode-return stream with ``torch.equal`` / exact equality.
* Across packages, both ways: one package's trainer stops at 20, the
  other's resumes to 40 from its files (the ``ReturnStream`` carry rides
  in the manifest), against the resuming package's own straight
  ``fit(40)``: streams and episode returns exact, params within 1e-5.
* A ``checkpoint``-site truncation plus a failed segment under
  ``max_restarts``: the supervisor walks past the corrupt checkpoint,
  replays, and ends equal to the fault-free fit. A persistent failure
  exhausts the budget; an unsupervised one propagates.
* ``LearnerDiverged`` raises on NaN params; resume refuses a mismatched
  config and a fresh fit refuses a directory that holds checkpoints.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import models as jmodels  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core.trainer import Trainer as JTrainer  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.optim import rmsprop as jrmsprop  # noqa: E402
from repro_torch import bridge, envs, models, optim  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.trainer import (CKPT_FORMAT, LearnerDiverged,  # noqa: E402
                                      Trainer)
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.faults import (FaultEvent, FaultInjector,  # noqa: E402
                                FaultPlan, InjectedFault)

EVERY = 10
PARAMS_TOL = 1e-5
CFG = dict(alpha=4, n_envs=4, seed=3)


def _jparams():
    pol = jmodels.get_policy("mlp", jcatch.make())
    return pol.init(jax.random.key(0))


def _port_rt(seed=3, nan=False):
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    params = bridge.policy_params_from_jax(
        jax.tree.map(np.asarray, _jparams()))
    if nan:
        params["w1"] = torch.full_like(params["w1"], float("nan"))
    return engine.make_runtime("mesh", env1, pol.apply, params,
                               optim.rmsprop(7e-4, eps=1e-5),
                               engine.HTSConfig(**{**CFG, "seed": seed}),
                               device="cpu")


def _jax_rt():
    env1 = jcatch.make()
    pol = jmodels.get_policy("mlp", env1)
    return jengine.make_runtime("mesh", env1, pol.apply, _jparams(),
                                jrmsprop(7e-4, eps=1e-5),
                                jengine.HTSConfig(**CFG))


def _fit(ckpt_dir, n, resume=False, faults=None, rt=None):
    return Trainer(rt or _port_rt(), checkpoint_dir=str(ckpt_dir),
                   ckpt_every=EVERY, faults=faults).fit(n, resume=resume)


def _assert_bitexact(got, want):
    for a, b in zip(tree_leaves(got.state), tree_leaves(want.state)):
        assert torch.equal(a.cpu(), b.cpu())
    for k in want.params:
        assert torch.equal(got.params[k], want.params[k]), k
    np.testing.assert_array_equal(got.episode_returns, want.episode_returns)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The port's uninterrupted fit(40): the oracle of this file."""
    return _fit(tmp_path_factory.mktemp("straight") / "ck", 40)


def test_resume_equals_uninterrupted_fit(tmp_path, straight):
    first = _fit(tmp_path / "ck", 20)
    assert first.intervals == 20
    assert ckpt_io.latest(str(tmp_path / "ck")).endswith("step_00000020")
    meta = ckpt_io.load_metadata(ckpt_io.latest(str(tmp_path / "ck")))
    assert meta["format"] == CKPT_FORMAT and meta["runtime"] == "mesh"
    assert meta["intervals"] == 20 and meta["metrics"]["n_envs"] == 4
    resumed = _fit(tmp_path / "ck", 40, resume=True)
    assert resumed.resumed_from == 20 and resumed.intervals == 40
    _assert_bitexact(resumed, straight)
    np.testing.assert_array_equal(
        np.concatenate([first.rewards, resumed.rewards]), straight.rewards)
    assert len(straight.episode_returns) > 0


def test_jax_stops_port_resumes(tmp_path, straight):
    JTrainer(_jax_rt(), checkpoint_dir=str(tmp_path / "ck"),
             ckpt_every=EVERY).fit(20)
    resumed = _fit(tmp_path / "ck", 40, resume=True)
    np.testing.assert_array_equal(resumed.rewards, straight.rewards[20:])
    np.testing.assert_array_equal(resumed.dones, straight.dones[20:])
    np.testing.assert_array_equal(resumed.episode_returns,
                                  straight.episode_returns)
    for k in straight.params:
        diff = (resumed.params[k] - straight.params[k]).abs().max().item()
        assert diff <= PARAMS_TOL, (k, diff)


def test_port_stops_jax_resumes(tmp_path):
    _fit(tmp_path / "ck", 20)
    resumed = JTrainer(_jax_rt(), checkpoint_dir=str(tmp_path / "ck"),
                       ckpt_every=EVERY).fit(40, resume=True)
    jstraight = JTrainer(_jax_rt(), checkpoint_dir=str(tmp_path / "j"),
                         ckpt_every=EVERY).fit(40)
    assert resumed.resumed_from == 20
    np.testing.assert_array_equal(resumed.rewards, jstraight.rewards[20:])
    np.testing.assert_array_equal(resumed.episode_returns,
                                  jstraight.episode_returns)
    for k, v in jstraight.params.items():
        diff = np.abs(np.asarray(resumed.params[k]) - np.asarray(v)).max()
        assert diff <= PARAMS_TOL, (k, diff)


def _fail_segment_once(rt, at: int, times: int = 1):
    """Make the segment that starts at interval ``at`` raise, ``times``
    times: a learner death the ported runtime cannot inject itself."""
    real = rt.run_from
    left = [times]

    def run_from(state, n, finalize=True):
        if int(state.interval) == at and left[0]:
            left[0] -= 1
            raise InjectedFault(FaultEvent("learner", at))
        return real(state, n, finalize)

    rt.run_from = run_from
    return rt


def test_truncated_checkpoint_recovery_equals_fault_free(tmp_path,
                                                         straight):
    inj = FaultInjector(FaultPlan(events=(("checkpoint", 20, "truncate"),),
                                  max_restarts=2, backoff=0.0,
                                  backoff_cap=0.0))
    rep = _fit(tmp_path / "ck", 40, faults=inj,
               rt=_fail_segment_once(_port_rt(), at=20))
    assert not inj.armed and rep.restarts == 1
    # step_20 was truncated: the walk fell back to step_10
    assert rep.recoveries[0]["restored_to"] == 10
    assert "InjectedFault" in rep.recoveries[0]["failure"]
    _assert_bitexact(rep, straight)
    np.testing.assert_array_equal(rep.rewards, straight.rewards)


def test_restart_budget_and_unsupervised_failures_raise(tmp_path):
    plan = FaultPlan(max_restarts=1, backoff=0.0, backoff_cap=0.0)
    with pytest.raises(InjectedFault):
        _fit(tmp_path / "a", 30, faults=plan,
             rt=_fail_segment_once(_port_rt(), at=10, times=2))
    with pytest.raises(InjectedFault):
        _fit(tmp_path / "b", 30, rt=_fail_segment_once(_port_rt(), at=10))


def test_learner_diverged_on_nan_params(tmp_path):
    with pytest.raises(LearnerDiverged, match="non-finite"):
        _fit(tmp_path / "a", 10, faults=FaultPlan(),
             rt=_port_rt(nan=True))
    assert ckpt_io.latest(str(tmp_path / "a")) is None    # never durable
    with pytest.raises(LearnerDiverged):
        _fit(tmp_path / "b", 10, rt=_port_rt(nan=True),
             faults=FaultPlan(max_restarts=1, backoff=0.0, backoff_cap=0.0))


def test_resume_checks(tmp_path):
    _fit(tmp_path / "ck", 10)
    with pytest.raises(ValueError, match="already holds checkpoints"):
        _fit(tmp_path / "ck", 20)
    with pytest.raises(ValueError, match="resume mismatch: checkpoint has "
                                         "seed=3"):
        _fit(tmp_path / "ck", 20, resume=True, rt=_port_rt(seed=4))
    # at the target already: reports the restored state through a
    # 0-interval segment
    rep = _fit(tmp_path / "ck", 10, resume=True)
    assert rep.intervals == 10 and rep.steps == 0
