"""The public env registration of both packages: ``@register_env`` and
``@register_device_port``.

A toy env (a walk on a ring of 4 cells, a seeded start and a seeded
payout, episodes of 5 steps) is written once for each package and
registered in each under the same name, with a batched device port. A
spec naming it builds through ``api.build`` in both packages, on the
host and on the device env backend; the port's reward and done streams
equal the reference's exactly, and its params are within 1e-5 of the
reference's after 2 intervals from the same params. Each test restores
the registries it touched.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import envs as jenvs  # noqa: E402
from repro.envs import device as jdevice  # noqa: E402
from repro.envs import interfaces as jinterfaces  # noqa: E402
from repro_torch import api, bridge, envs  # noqa: E402
from repro_torch.core import determinism  # noqa: E402
from repro_torch.envs import device as tdevice  # noqa: E402
from repro_torch.envs import interfaces  # noqa: E402

NAME = "toy_walk"
CELLS, LENGTH = 4, 5
INTERVALS = 2
PARAMS_TOL = 1e-5


# ------------------------------------------------------------ JAX side
def _j_obs(s):
    return jnp.stack([s["pos"] / CELLS, s["t"] / LENGTH, jnp.float32(1.0),
                      (s["pos"] == 0).astype(jnp.float32)]).astype(
                          jnp.float32)


def _j_reset(key):
    s = {"pos": jax.random.randint(key, (), 0, CELLS),
         "t": jnp.zeros((), jnp.int32)}
    return s, _j_obs(s)


def _j_step(s, action, key):
    pos = (s["pos"] + action.astype(jnp.int32)) % CELLS
    t = s["t"] + 1
    paid = jax.random.uniform(key) < 0.7
    reward = jnp.where((pos == 0) & paid, 1.0, 0.0).astype(jnp.float32)
    ns = {"pos": pos, "t": t}
    return ns, _j_obs(ns), reward, (t >= LENGTH).astype(jnp.float32)


def _j_make():
    return jinterfaces.with_autoreset(NAME, _j_reset, _j_step, (4,), 3)


def _j_port():
    return jdevice.device_autoreset(f"{NAME}@device", jax.vmap(_j_reset),
                                    jax.vmap(_j_step), (4,), 3, NAME)


# ----------------------------------------------------------- port side
def _t_obs(s):
    return torch.stack([s["pos"] / CELLS, s["t"] / LENGTH,
                        torch.ones_like(s["pos"], dtype=torch.float32),
                        (s["pos"] == 0).to(torch.float32)],
                       dim=-1).to(torch.float32)


def _t_reset(key):
    s = {"pos": determinism.randint(key, (), 0, CELLS),
         "t": torch.zeros(key.shape[:-1], dtype=torch.int32,
                          device=key.device)}
    return s, _t_obs(s)


def _t_step(s, action, key):
    pos = (s["pos"] + action.to(torch.int32)) % CELLS
    t = s["t"] + 1
    paid = determinism.uniform(key, ()) < 0.7
    reward = torch.where((pos == 0) & paid, 1.0, 0.0).to(torch.float32)
    ns = {"pos": pos, "t": t}
    return ns, _t_obs(ns), reward, (t >= LENGTH).to(torch.float32)


def _t_make():
    return interfaces.with_autoreset(NAME, _t_reset, _t_step, (4,), 3)


def _t_port():
    # the scalar functions already broadcast over a leading key axis
    return tdevice.device_autoreset(f"{NAME}@device", _t_reset, _t_step,
                                    (4,), 3, NAME)


@pytest.fixture
def registered(monkeypatch):
    """The toy env and its device port registered in both packages
    through the public decorators, on copies of the registries."""
    for mod in (jenvs, jdevice, envs, tdevice):
        monkeypatch.setattr(mod, "_REGISTRY", dict(mod._REGISTRY))
    jenvs.register_env(NAME)(_j_make)
    jdevice.register_device_port(NAME)(_j_port)
    assert envs.register_env(NAME)(_t_make) is _t_make
    assert tdevice.register_device_port(NAME)(_t_port) is _t_port
    yield


def _spec(backend):
    return {"env": NAME, "policy": "mlp", "algorithm": "a2c",
            "optimizer": {"name": "rmsprop", "kwargs": {"lr": 7e-4,
                                                        "eps": 1e-5}},
            "runtime": "mesh", "intervals": INTERVALS,
            "hts": {"alpha": 4, "n_envs": 8, "seed": 2,
                    "env_backend": backend}}


def test_registered_names_resolve(registered):
    assert NAME in envs.env_names() and NAME in jenvs.env_names()
    assert envs.get_env(NAME).obs_shape == (4,)
    assert tdevice.has_device_port(NAME)
    assert NAME in tdevice.device_port_names()
    assert tdevice.get_device_env(NAME).host_name == NAME


@pytest.mark.parametrize("backend", ["host", "device"])
def test_spec_naming_the_toy_env_matches_jax(registered, backend):
    jsession = japi.build(japi.ExperimentSpec(**_spec(backend)))
    session = api.build(api.ExperimentSpec(**_spec(backend)), device="cpu")
    session.runtime.params0 = bridge.policy_params_from_jax(
        jax.tree.map(np.asarray, jsession.params))
    jout, out = jsession.run(), session.run()
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    assert float(np.asarray(out.rewards).sum()) > 0
    assert float(np.asarray(out.dones).sum()) > 0
    for k, v in jout.params.items():
        diff = np.abs(out.params[k].numpy() - np.asarray(v)).max()
        assert diff <= PARAMS_TOL, (k, diff)


def test_unregistered_name_still_raises():
    with pytest.raises(KeyError, match="registered"):
        envs.get_env(NAME)
    assert not tdevice.has_device_port(NAME)


# ------------------------------- the device-port names of the registry
@pytest.mark.parametrize("name", ["catch", "gridmaze", "token", NAME])
def test_has_device_port_agrees_with_the_reference(registered, name):
    assert envs.has_device_port(name) == jenvs.has_device_port(name)
    assert envs.has_device_port(name) == (name != "token")


@pytest.mark.parametrize("name", ["catch", "gridmaze", NAME])
@pytest.mark.parametrize("where", ["envs.get_device_env",
                                   "envs.device.make_device_env"])
def test_device_env_names_build_the_reference_port(registered, name, where):
    """``envs.get_device_env`` and ``envs.device.make_device_env`` of both
    packages build ports whose reset obs are equal from the same keys."""
    mod, attr = where.rsplit(".", 1)
    ours = {"envs": envs, "envs.device": tdevice}[mod]
    ref = {"envs": jenvs, "envs.device": jdevice}[mod]
    tenv, jenv = getattr(ours, attr)(name), getattr(ref, attr)(name)
    assert tenv.host_name == jenv.host_name == name
    _, obs = tenv.reset(determinism.split(determinism.master_key(5), 6))
    _, jobs = jenv.reset(jax.random.split(jax.random.key(5), 6))
    assert obs.shape == (6,) + tuple(tenv.obs_shape)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))


def test_unknown_device_port_raises_in_both_packages():
    for fn in (envs.get_device_env, jenvs.get_device_env,
               tdevice.make_device_env, jdevice.make_device_env):
        with pytest.raises(ValueError, match="has no device-resident port"):
            fn("no_such_env")
    assert not envs.has_device_port("no_such_env")
