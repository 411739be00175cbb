"""The RL slice's policies, update math and optimizers against live JAX,
from the same params carried across the bridge:

* logits and values: mlp 1e-5, cnn at reduced widths 1e-5, the paper CNN
  at its published widths (batch 2 of (84, 84, 4)) 1e-5 relative;
* on a fixed trajectory, for all five algorithm names with ``use_gae`` on
  and off: the loss within 1e-5 relative of JAX's, every gradient leaf
  within 1e-5 of its largest magnitude, against ``jax.grad``;
* one step of each optimizer, and its fp32 state, within 1e-6 relative.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import algorithms as jalgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs.paper_cnn import CNNPolicyConfig as JCNNConfig  # noqa: E402
from repro.core import losses as jlosses  # noqa: E402
from repro.core import vtrace as jvtrace  # noqa: E402
from repro.core.engine import HTSConfig as JHTSConfig  # noqa: E402
from repro.envs import catch as jcatch  # noqa: E402
from repro.envs.interfaces import Env as JEnv  # noqa: E402
from repro_torch import algorithms as talgs  # noqa: E402
from repro_torch import bridge, envs, models  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs.paper_cnn import CNNPolicyConfig  # noqa: E402
from repro_torch.core import determinism as tdet  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import vtrace as tvtrace  # noqa: E402
from repro_torch.core.engine import HTSConfig  # noqa: E402
from repro_torch.envs.interfaces import Env as TEnv  # noqa: E402

ALGORITHMS = ("a2c", "ppo", "vtrace", "epsilon", "trunc_is")
# reduced CNN widths: three convs and the heads at a few channels
SMALL_CNN = dict(conv_filters=(4, 8, 8), conv_sizes=(4, 3, 2),
                 conv_strides=(2, 1, 1), hidden=32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(t, j):
    """max |t - j| over max |j| (1 where j is all zeros)."""
    j = np.asarray(j, np.float64)
    scale = np.abs(j).max() or 1.0
    return float(np.abs(t.detach().cpu().numpy() - j).max() / scale)


def _envs(obs_shape, n_actions):
    """Stand-in envs that only size the policies."""
    je = JEnv("shape", None, None, obs_shape, n_actions)
    te = TEnv("shape", None, None, obs_shape, n_actions)
    return je, te


def _policies(name, obs_shape=(10, 5, 1), n_actions=3, **kw):
    je, te = _envs(obs_shape, n_actions)
    jp = jmodels.get_policy(name, je, **kw)
    tp = models.get_policy(name, te, **kw)
    params = jp.init(jax.random.key(0))
    return jp, tp, params, bridge.policy_params_from_jax(_np(params))


# ---------------------------------------------------------------- policies
@pytest.mark.parametrize("case", ["mlp", "mlp-wide", "cnn-reduced",
                                  "token"])
def test_policy_logits_and_values(case):
    rng = np.random.default_rng(1)
    if case.startswith("mlp"):
        kw = {"hidden": 256} if case == "mlp-wide" else {}
        jp, tp, jpar, tpar = _policies("mlp", **kw)
        obs = rng.random((7, 10, 5, 1), np.float32)
    elif case == "cnn-reduced":
        jp, tp, jpar, tpar = _policies("cnn", (16, 16, 2), 5, **SMALL_CNN)
        obs = rng.random((3, 16, 16, 2), np.float32)
    else:
        jp, tp, jpar, tpar = _policies("token", (), 11, hidden=16)
        obs = rng.integers(0, 11, (9,)).astype(np.int32)
    jl, jv = jp.apply(jpar, jnp.asarray(obs))
    tl, tv = tp.apply(tpar, torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)


def test_paper_cnn_at_published_widths():
    """configs/paper_cnn.py unchanged: (84, 84, 4), 32x8x8/4, 64x4x4/2,
    64x3x3/1, fc 512, 18 actions; logits and values of a batch of 2 from
    the same params within 1e-5 relative."""
    cfg = CNNPolicyConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JCNNConfig())
    assert (cfg.obs_shape, cfg.conv_filters, cfg.conv_sizes,
            cfg.conv_strides, cfg.hidden, cfg.n_actions) == (
        (84, 84, 4), (32, 64, 64), (8, 4, 3), (4, 2, 1), 512, 18)
    jp, tp, jpar, tpar = _policies("cnn", cfg.obs_shape, cfg.n_actions)
    assert tuple(tpar["conv0_w"].shape) == (32, 4, 8, 8)        # OIHW
    assert tuple(tpar["fc_w"].shape) == (7 * 7 * 64, 512)
    obs = np.random.default_rng(2).random((2, 84, 84, 4), np.float32)
    jl, jv = jp.apply(jpar, jnp.asarray(obs))
    tl, tv = tp.apply(tpar, torch.from_numpy(obs))
    assert _rel(tl, jl) <= 1e-5 and _rel(tv, jv) <= 1e-5


@pytest.mark.parametrize("case", ["mlp", "cnn-reduced", "cnn-paper",
                                  "token"])
def test_init_from_params_seed_within_ulps(case):
    """Init from the same key: every leaf within 4 ulp of JAX's (3 is the
    largest seen: the normals' erfinv), shapes as the bridge makes them."""
    if case == "mlp":
        je, te = _envs((10, 5, 1), 3)
        jp, tp = jmodels.get_policy("mlp", je), models.get_policy("mlp", te)
    elif case.startswith("cnn"):
        kw = SMALL_CNN if case == "cnn-reduced" else {}
        shape = (16, 16, 2) if kw else (84, 84, 4)
        je, te = _envs(shape, 5)
        jp = jmodels.get_policy("cnn", je, **kw)
        tp = models.get_policy("cnn", te, **kw)
    else:
        je, te = _envs((), 11)
        jp, tp = (jmodels.get_policy("token", je),
                  models.get_policy("token", te))
    for seed in (0, 7):
        want = bridge.policy_params_from_jax(_np(jp.init(
            jax.random.key(seed))))
        got = tp.init(tdet.master_key(seed))
        assert set(want) == set(got)
        for k in want:
            w, g = want[k].numpy(), got[k].numpy()
            assert g.shape == w.shape and g.dtype == np.float32, k
            ulps = np.abs(w.astype(np.float64) - g) / np.spacing(
                np.maximum(np.abs(w), np.float32(1e-30)))
            assert ulps.max() <= 4, (k, ulps.max())


def test_policy_registry():
    te = envs.get_env("catch")
    assert models.policy_names() == ["backbone", "cnn", "mlp", "token"]
    # the LLM policy: flat params, no per-step apply (the stream
    # runtime's learner consumes it); every registered arch builds, the
    # encoder-decoder with its encoder and cross-attention
    pol = models.get_policy("backbone", te, arch="rwkv6-7b", reduced=True)
    assert pol.apply is None and pol.config.n_layers == 2
    assert "layers.1.mixer.u" in pol.init(tdet.master_key(0))
    pol = models.get_policy("backbone", te, arch="whisper-medium",
                            reduced=True)
    assert {"encoder.layers.1.mixer.wq", "layers.1.xattn.wo"} <= set(
        pol.init(tdet.master_key(0)))
    with pytest.raises(KeyError, match="registered"):
        models.get_policy("transformer", te)
    # the mlp flattens image observations
    params = models.get_policy("mlp", te).init(tdet.master_key(0))
    assert tuple(params["w1"].shape) == (50, 128)


# ------------------------------------------------------------- update math
ALPHA, N_ENVS = 5, 4


def _trajectory(seed=0):
    """A fixed trajectory of catch-shaped observations: numpy leaves with
    the rollout's dtypes (int32 actions; fp32 rewards, dones and
    behavior logprobs), dones at a few steps."""
    rng = np.random.default_rng(seed)
    obs = (rng.random((ALPHA, N_ENVS, 10, 5, 1)) < 0.2).astype(np.float32)
    dones = np.zeros((ALPHA, N_ENVS), np.float32)
    dones[2, 1] = dones[4, 0] = dones[0, 3] = 1.0
    return {
        "obs": obs,
        "actions": rng.integers(0, 3, (ALPHA, N_ENVS)).astype(np.int32),
        "rewards": (rng.integers(-1, 2, (ALPHA, N_ENVS)) * dones).astype(
            np.float32),
        "dones": dones,
        "behavior_logprob": np.log(rng.uniform(0.2, 0.6, (ALPHA, N_ENVS))
                                   ).astype(np.float32),
        "bootstrap_obs": (rng.random((N_ENVS, 10, 5, 1)) < 0.2).astype(
            np.float32),
    }


@pytest.mark.parametrize("use_gae", [False, True])
@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_loss_and_gradient_match_jax(algorithm, use_gae):
    jp, tp, jpar, tpar = _policies("mlp")
    traj = _trajectory()
    jcfg = JHTSConfig(alpha=ALPHA, n_envs=N_ENVS, algorithm=algorithm,
                      use_gae=use_gae)
    tcfg = HTSConfig(alpha=ALPHA, n_envs=N_ENVS, algorithm=algorithm,
                     use_gae=use_gae)
    jalg, talg = jalgs.get_algorithm(algorithm), talgs.get_algorithm(
        algorithm)
    jtraj = {k: jnp.asarray(v) for k, v in traj.items()}
    ttraj = {k: torch.from_numpy(v) for k, v in traj.items()}
    (jl, jst), jg = jax.jit(jax.value_and_grad(
        lambda p: jalg.loss(jp.apply, p, jtraj, jcfg), has_aux=True))(jpar)
    tl, tst = talg.loss(tp.apply, tpar, ttraj, tcfg)
    assert _rel(tl, jl) <= 1e-5
    for a, b in zip(tst, jst):
        assert abs(float(a) - float(b)) <= 1e-5 * max(abs(float(b)), 1e-3)
    tg = torch.func.grad(lambda p: talg.loss(tp.apply, p, ttraj, tcfg)[0])(
        tpar)
    assert set(tg) == set(jg)
    for k in jg:
        assert tg[k].dtype == torch.float32
        assert _rel(tg[k], jg[k]) <= 1e-5, (k, _rel(tg[k], jg[k]))


def test_algorithm_registry():
    assert talgs.algorithm_names() == sorted(ALGORITHMS)
    with pytest.raises(KeyError, match="registered"):
        talgs.get_algorithm("dqn")
    with pytest.raises(ValueError, match="unknown correction"):
        talgs.vtrace.StaleCorrected("clip")


def _scan_inputs():
    t = _trajectory(3)
    rng = np.random.default_rng(4)
    values = rng.normal(size=(ALPHA, N_ENVS)).astype(np.float32)
    boot = rng.normal(size=(N_ENVS,)).astype(np.float32)
    tlp = np.log(rng.uniform(0.1, 0.9, (ALPHA, N_ENVS))).astype(np.float32)
    return t, values, boot, tlp


def test_returns_gae_and_vtrace_match_jax():
    t, values, boot, tlp = _scan_inputs()
    T = {k: torch.from_numpy(v) for k, v in t.items()}
    want = jlosses.n_step_returns(t["rewards"], t["dones"], boot, 0.99)
    got = tlosses.n_step_returns(T["rewards"], T["dones"],
                                 torch.from_numpy(boot), 0.99)
    assert _rel(got, want) <= 1e-6
    for w, g in zip(jlosses.gae(t["rewards"], t["dones"], values, boot, 0.99,
                                0.9),
                    tlosses.gae(T["rewards"], T["dones"],
                                torch.from_numpy(values),
                                torch.from_numpy(boot), 0.99, 0.9)):
        assert _rel(g, w) <= 1e-6
    for w, g in zip(jvtrace.vtrace(t["behavior_logprob"], tlp, t["rewards"],
                                   t["dones"], values, boot, 0.99),
                    tvtrace.vtrace(T["behavior_logprob"],
                                   torch.from_numpy(tlp), T["rewards"],
                                   T["dones"], torch.from_numpy(values),
                                   torch.from_numpy(boot), 0.99)):
        assert _rel(g, w) <= 1e-6


def test_losses_differentiate_without_in_place_writes():
    """torch.func vmaps and differentiates the reverse-time loops."""
    t, values, boot, _ = _scan_inputs()
    T = {k: torch.from_numpy(v) for k, v in t.items()}

    def f(v):
        return tlosses.gae(T["rewards"], T["dones"], v,
                           torch.from_numpy(boot), 0.99)[1].sum()

    g = torch.func.vmap(torch.func.grad(f))(torch.from_numpy(values)[None]
                                            .repeat(3, 1, 1))
    assert g.shape == (3, ALPHA, N_ENVS) and torch.isfinite(g).all()


# ------------------------------------------------------------ optimizers
OPTIMIZERS = {
    "sgd": dict(lr=0.1),
    "rmsprop": dict(lr=7e-4, eps=1e-5),
    "rmsprop-momentum": dict(lr=7e-4, eps=1e-5, momentum=0.9),
    "adam": dict(lr=3e-4),
    "adam-clip": dict(lr=3e-4, clip_norm=0.5),
    "rmsprop-clip": dict(lr=7e-4, eps=1e-5, clip_norm=1e3),
}


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 1)
                ).astype(np.float32) for k, v in params.items()}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    """Three steps from the same params and gradients: updated params and
    every fp32 state leaf within 1e-6 relative."""
    kw = OPTIMIZERS[name]
    base = name.split("-")[0]
    jopt, topt = (joptim.get_optimizer(base, **kw),
                  toptim.get_optimizer(base, **kw))
    _, _, jpar, tpar = _policies("cnn", (16, 16, 2), 5, **SMALL_CNN)
    jstate, tstate = jopt.init(jpar), topt.init(tpar)
    jupdate = jax.jit(jopt.update)
    for step in range(3):
        g = _grads(jpar, step)
        jupd, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jpar)
        tupd, tstate = topt.update(bridge.policy_params_from_jax(g), tstate,
                                   tpar)
        jpar = joptim.apply_updates(jpar, jupd)
        tpar = toptim.apply_updates(tpar, tupd)
    for k in jpar:
        assert _rel(tpar[k], bridge.policy_params_from_jax(
            {k: np.asarray(jpar[k])})[k].numpy()) <= 1e-6, k
    want = bridge.opt_state_from_jax(_np(jstate))
    wl, gl = bridge.tree_leaves(want), bridge.tree_leaves(tstate)
    assert len(wl) == len(gl)
    for w, g in zip(wl, gl):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _rel(g, w.numpy()) <= 1e-6


def test_optimizer_registry_and_schedules():
    assert toptim.optimizer_names() == ["adam", "rmsprop", "sgd"]
    with pytest.raises(KeyError, match="registered"):
        toptim.get_optimizer("lamb", lr=1.0)
    sch = toptim.schedules
    jsch = joptim.schedules
    for step in (0, 3, 10, 40, 200):
        for t, j in ((sch.constant(0.1), jsch.constant(0.1)),
                     (sch.linear_decay(0.1, 100, 0.01),
                      jsch.linear_decay(0.1, 100, 0.01)),
                     (sch.warmup_cosine(0.1, 10, 100),
                      jsch.warmup_cosine(0.1, 10, 100))):
            assert abs(float(t(step)) - float(j(step))) <= 1e-7
    topt = sch.scheduled(lambda lr: toptim.sgd(lr), sch.linear_decay(1.0, 4))
    jopt = jsch.scheduled(lambda lr: joptim.sgd(lr),
                          jsch.linear_decay(1.0, 4))
    p = {"w": np.ones((3,), np.float32)}
    ts, js = topt.init(bridge.policy_params_from_jax(p)), jopt.init(p)
    for _ in range(3):
        tu, ts = topt.update({"w": torch.ones(3)}, ts)
        ju, js = jopt.update({"w": jnp.ones(3)}, js)
        np.testing.assert_allclose(tu["w"].numpy(), np.asarray(ju["w"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3


def test_optimizers_write_nothing_in_place():
    """The rollout stream reads theta_j while the learner makes
    theta_{j+1}: an update must leave its inputs as they were."""
    _, _, _, tpar = _policies("mlp")
    before = {k: v.clone() for k, v in tpar.items()}
    for name, kw in OPTIMIZERS.items():
        opt = toptim.get_optimizer(name.split("-")[0], **kw)
        state = opt.init(tpar)
        state_before = [x.clone() for x in bridge.tree_leaves(state)]
        upd, new_state = opt.update(
            {k: torch.ones_like(v) for k, v in tpar.items()}, state, tpar)
        toptim.apply_updates(tpar, upd)
        assert all(torch.equal(a, b) for a, b in
                   zip(bridge.tree_leaves(state), state_before)), name
    assert all(torch.equal(tpar[k], before[k]) for k in tpar)


def test_catch_env_sizes_the_mlp_as_the_reference():
    jp = jmodels.get_policy("mlp", jcatch.make())
    tp = models.get_policy("mlp", envs.get_env("catch"))
    jpar, tpar = jp.init(jax.random.key(0)), tp.init(tdet.master_key(0))
    assert {k: tuple(v.shape) for k, v in jpar.items()} == {
        k: tuple(v.shape) for k, v in tpar.items()}
