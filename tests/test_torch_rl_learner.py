"""The RL slice's learner against live JAX, and its own contracts:

* ``pairwise_tree_sum`` adds in the reference's order (bit-exact);
  ``BatchConfig`` (the reference's code, copied) accepts, resolves and
  rejects exactly as the reference's;
* one ``make_learner_update`` pass from a JAX ``DelayedGradState`` and
  trajectory carried across the bridge: params within 1e-5, the rmsprop
  state within 1e-5 relative, ``step`` and the behavior history equal;
* within the port, params and streams are bit-exact (``torch.equal``)
  across the (grad_accumulation, n_replicas) factorizations of
  ``tests/test_batch_geometry.py::test_mesh_factorization_cells_bitexact``;
* ``delayed_grad``: the K-deep ring, ``skip``, and no in-place writes.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import models as jmodels  # noqa: E402
from repro.core import batch as jbatch  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.core import mesh_runtime as jmesh  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.optim import rmsprop as jrmsprop  # noqa: E402
from repro_torch import bridge, envs, models  # noqa: E402
from repro_torch.core import batch as tbatch  # noqa: E402
from repro_torch.core import delayed_grad as tdg  # noqa: E402
from repro_torch.core import determinism as tdet  # noqa: E402
from repro_torch.core import engine as tengine  # noqa: E402
from repro_torch.core import mesh_runtime as tmesh  # noqa: E402
from repro_torch.optim import rmsprop as trmsprop  # noqa: E402


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _traj_to_torch(traj):
    return {k: bridge.to_torch(v) for k, v in _np(traj).items()}


# ------------------------------------------------------------ reduction
@pytest.mark.parametrize("n", list(range(1, 18)) + [31, 64, 100])
def test_pairwise_tree_sum_bit_exact(n):
    x = (np.random.default_rng(n).normal(size=(n, 3, 5))
         * 10.0 ** np.random.default_rng(n + 1).integers(-4, 4, (n, 1, 1))
         ).astype(np.float32)
    want = np.asarray(jbatch.pairwise_tree_sum(jnp.asarray(x)))
    got = tbatch.pairwise_tree_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))


def _resolve(mod, n, **kw):
    try:
        return mod.BatchConfig.of(kw).resolve(n)
    except ValueError as e:
        return str(e)


def test_batch_config_matches_the_reference():
    """Every geometry of small global batches: the same resolution, or
    the same error message."""
    for n in range(1, 17):
        for a in (1, 2, 3, 4, 8):
            for r in (None, 1, 2, 3, 4):
                for micro in (None, 1, 2, 4):
                    kw = {"grad_accumulation": a, "n_replicas": r,
                          "micro_batch": micro}
                    want, got = _resolve(jbatch, n, **kw), _resolve(
                        tbatch, n, **kw)
                    assert str(want) == str(got), (n, kw)
    for bad in ({"grad_accumulation": 0}, {"n_replicas": True},
                {"micro_batch": -1}, {"global": 3}):
        with pytest.raises(ValueError) as jerr:
            jbatch.BatchConfig.of(bad)
        with pytest.raises(ValueError) as terr:
            tbatch.BatchConfig.of(bad)
        assert str(jerr.value) == str(terr.value)


# ------------------------------------------------------------ delayed grad
def _small_params():
    return models.get_policy("mlp", envs.get_env("catch"), hidden=8).init(
        tdet.master_key(1))


@pytest.mark.parametrize("K", [1, 2, 4])
def test_delayed_grad_ring_and_skip(K):
    opt = trmsprop(1e-2)
    params = _small_params()
    dg = tdg.init(params, opt, staleness=K)
    assert tdg.behavior_lag(dg) == K and dg.step.dtype == torch.int32
    history = [params]
    for i in range(5):
        grads = {k: torch.full_like(v, 0.5) for k, v in dg.params.items()}
        before = {k: v.clone() for k, v in dg.params.items()}
        skip = i == 1
        new = tdg.update(dg, grads, opt, skip=skip)
        # nothing written in place: the rollout may still read dg.params
        assert all(torch.equal(dg.params[k], before[k]) for k in before)
        if skip:
            assert new.params is dg.params and new.opt_state is dg.opt_state
            assert int(new.step) == int(dg.step)
        else:
            assert not torch.equal(new.params["w1"], dg.params["w1"])
            assert int(new.step) == int(dg.step) + 1
        dg = new
        history.append(dg.params)
        # the behavior point is the params of K updates ago
        bp = tdg.behavior_params(dg)
        want = history[max(len(history) - 1 - K, 0)]
        assert all(torch.equal(bp[k], want[k]) for k in want)
    assert int(dg.step) == 4
    with pytest.raises(ValueError, match="staleness"):
        tdg.init(params, opt, staleness=0)


def test_ring_read_and_append():
    slot = lambda v: {"x": torch.full((2,), float(v))}  # noqa: E731
    assert tmesh.ring_read(slot(1), 1)["x"][0] == 1
    assert tmesh.ring_append(slot(1), slot(2), 1)["x"][0] == 2
    ring = {"x": torch.stack([torch.full((2,), float(v)) for v in (1, 2, 3)])}
    assert tmesh.ring_read(ring, 3)["x"][0] == 1
    ring = tmesh.ring_append(ring, slot(4), 3)
    assert ring["x"][:, 0].tolist() == [2.0, 3.0, 4.0]


# ------------------------------------------------------ the learner pass
_memo = {}


def _jax_state(algorithm, K, intervals=2):
    """A JAX mesh run's mid-stream state, memoised per configuration."""
    if (algorithm, K, intervals) in _memo:
        return _memo[(algorithm, K, intervals)]
    env1 = jcatch.make()
    cfg = jengine.HTSConfig(alpha=4, n_envs=4, seed=3, algorithm=algorithm,
                            staleness=K)
    pol = jmodels.get_policy("mlp", env1)
    rt = jengine.make_runtime("mesh", env1, pol.apply,
                              pol.init(jax.random.key(0)),
                              jrmsprop(7e-4, eps=1e-5), cfg)
    rt.run(intervals)
    _memo[(algorithm, K, intervals)] = pol, cfg, rt.state()
    return _memo[(algorithm, K, intervals)]


def _assert_learner_pass(jdg_out, tdg_out):
    assert int(tdg_out.step) == int(jdg_out.step)
    want = bridge.delayed_grad_from_jax(_np(jdg_out))
    for k in want.params:
        d = (tdg_out.params[k] - want.params[k]).abs().max().item()
        assert d <= 1e-5, (k, d)
    for w, g in zip(bridge.tree_leaves(want.params_prev),
                    bridge.tree_leaves(tdg_out.params_prev)):
        assert torch.equal(w, g)
    for w, g in zip(bridge.tree_leaves(want.opt_state),
                    bridge.tree_leaves(tdg_out.opt_state)):
        assert g.dtype == torch.float32
        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-5


@pytest.mark.parametrize("algorithm,K", [("a2c", 1), ("ppo", 1),
                                         ("vtrace", 2)])
def test_learner_pass_from_a_jax_state(algorithm, K):
    """Two JAX intervals, then one learner pass on the pending ring slot,
    in JAX and in the port from the bridged state."""
    pol, cfg, state = _jax_state(algorithm, K)
    jlearn = jax.jit(jmesh.make_learner_update(
        pol.apply, jrmsprop(7e-4, eps=1e-5), cfg))
    jout = jlearn(state.algo, jmesh.ring_read(state.buffer, K))
    tcfg = tengine.HTSConfig(alpha=4, n_envs=4, seed=3, algorithm=algorithm,
                             staleness=K)
    tpol = models.get_policy("mlp", envs.get_env("catch"))
    tlearn = tmesh.make_learner_update(tpol.apply, trmsprop(7e-4, eps=1e-5),
                                       tcfg)
    tdg_in = bridge.delayed_grad_from_jax(_np(state.algo))
    assert tdg.behavior_lag(tdg_in) == K
    tout = tlearn(tdg_in, tmesh.ring_read(_traj_to_torch(state.buffer), K))
    _assert_learner_pass(jout, tout)


def test_cnn_learner_pass_from_a_jax_state():
    """The conv trunk (reduced widths, on catch's (10, 5, 1) boards): the
    bridge turns the HWIO kernels, their ring copies and their rmsprop
    state into OIHW; the per-env vmap(grad) runs the convs."""
    kw = dict(conv_filters=(4, 8, 8), conv_sizes=(3, 2, 1),
              conv_strides=(1, 1, 1), hidden=16)
    jenv = jcatch.make()
    jpol = jmodels.get_policy("cnn", jenv, **kw)
    cfg = jengine.HTSConfig(alpha=4, n_envs=4, seed=3, staleness=2)
    opt = jrmsprop(7e-4, eps=1e-5)
    rt = jengine.make_runtime("mesh", jenv, jpol.apply,
                              jpol.init(jax.random.key(0)), opt, cfg)
    rt.run(3)
    state = rt.state()
    jout = jax.jit(jmesh.make_learner_update(jpol.apply, opt, cfg))(
        state.algo, jmesh.ring_read(state.buffer, 2))
    tpol = models.get_policy("cnn", envs.get_env("catch"), **kw)
    tcfg = tengine.HTSConfig(alpha=4, n_envs=4, seed=3, staleness=2)
    tlearn = tmesh.make_learner_update(tpol.apply, trmsprop(7e-4, eps=1e-5),
                                       tcfg)
    tout = tlearn(bridge.delayed_grad_from_jax(_np(state.algo)),
                  tmesh.ring_read(_traj_to_torch(state.buffer), 2))
    assert tuple(tout.params_prev["conv0_w"].shape) == (2, 4, 1, 3, 3)
    _assert_learner_pass(jout, tout)


def test_grad_fn_equals_jax_grad_of_the_mean_loss():
    """make_grad_fn's tree sum over per-env grads, divided once, is the
    gradient of the mean interval loss: against JAX's make_grad_fn."""
    pol, cfg, state = _jax_state("a2c", 1)
    traj = state.buffer
    params = state.algo.params
    jg = jax.jit(jmesh.make_grad_fn(pol.apply, cfg))(params, traj)
    tpol = models.get_policy("mlp", envs.get_env("catch"))
    tcfg = tengine.HTSConfig(alpha=4, n_envs=4, seed=3)
    tg = tmesh.make_grad_fn(tpol.apply, tcfg)(
        bridge.policy_params_from_jax(_np(params)), _traj_to_torch(traj))
    for k in jg:
        w = np.asarray(jg[k])
        assert (np.abs(tg[k].numpy() - w).max() / np.abs(w).max()) <= 1e-5
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_grad_fn(tpol.apply, tcfg, grad_accumulation=3)(
            bridge.policy_params_from_jax(_np(params)), _traj_to_torch(traj))


# ------------------------------------------------------- factorizations
def _port_run(batch=None, n_envs=4, alpha=5):
    env1 = envs.get_env("catch")
    pol = models.get_policy("mlp", env1)
    cfg = tengine.HTSConfig(alpha=alpha, n_envs=n_envs, seed=3)
    return tengine.make_runtime("mesh", env1, pol.apply,
                                pol.init(tdet.master_key(0)),
                                trmsprop(7e-4, eps=1e-5), cfg, batch=batch,
                                device="cpu").run(3)


def _assert_bitexact(a, b):
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    np.testing.assert_array_equal(a.rewards, b.rewards)
    np.testing.assert_array_equal(a.dones, b.dones)


@pytest.mark.parametrize("R", [1, 2])
@pytest.mark.parametrize("A", [1, 2])
def test_mesh_factorization_cells_bitexact(R, A):
    base = _port_run()
    _assert_bitexact(base, _port_run({"n_replicas": R,
                                      "grad_accumulation": A}))


@pytest.mark.parametrize("batch", [{"grad_accumulation": 4},
                                   {"grad_accumulation": 2, "n_replicas": 4},
                                   {"micro_batch": 1, "grad_accumulation": 8}])
def test_wider_factorizations_bitexact(batch):
    _assert_bitexact(_port_run(n_envs=8, alpha=3),
                     _port_run(batch, n_envs=8, alpha=3))


def test_rejected_geometry_names_the_field():
    with pytest.raises(ValueError, match="nearest valid factorization"):
        _port_run({"grad_accumulation": 3})
