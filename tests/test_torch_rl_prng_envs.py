"""The RL slice's PRNG and envs against live JAX: ``split``, ``randint``
and the bits bit-exact, ``normal`` within 4 ulp (3 is the largest seen,
over 60 seeds of 4000 draws); catch (the vmapped host env and the
batched device port) bit-exact in every state leaf, obs, reward and done
through auto-resets, and the port's two backends bit-exact to each
other."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.envs import catch as jcatch  # noqa: E402
from repro.envs.device import get_device_env as j_device_env  # noqa: E402
from repro.envs.interfaces import vectorize as j_vectorize  # noqa: E402
from repro_torch import bridge, envs  # noqa: E402
from repro_torch.core import determinism as tdet  # noqa: E402
from repro_torch.envs import device as tdevice  # noqa: E402
from repro_torch.envs.interfaces import vectorize as t_vectorize  # noqa: E402

SEEDS = [0, 1, 3, 42, 0x5EED ^ 3, 2**31 - 1]
NORMAL_ULP = 4


def _jkey(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


# ------------------------------------------------------------------ PRNG
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 4, 7, 16, 1024])
def test_split_bit_exact(seed, num):
    np.testing.assert_array_equal(
        _jkey(jax.random.split(jax.random.key(seed), num)),
        tdet.split(tdet.master_key(seed), num).numpy())


def test_split_of_a_batch_of_keys_matches_vmap():
    jks = jax.random.split(jax.random.key(9), 6)
    tks = tdet.split(tdet.master_key(9), 6)
    np.testing.assert_array_equal(
        _jkey(jax.vmap(lambda k: jax.random.split(k, 3))(jks)),
        tdet.split(tks, 3).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
@pytest.mark.parametrize("bounds", [(0, 5), (0, 3), (-7, 100), (5, 5),
                                    (9, 2), (0, 65536), (0, 65537),
                                    (0, 1_000_003), (0, 2**31 - 1),
                                    (-2**31, 2**31 - 1)])
def test_randint_bit_exact(seed, shape, bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi))
    got = tdet.randint(tdet.master_key(seed), shape, lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_randint_for_a_batch_of_keys_matches_vmap():
    """The device catch draws its reset columns this way."""
    jks = jax.random.split(jax.random.key(3 ^ 0x5EED), 256)
    tks = tdet.split(tdet.master_key(3 ^ 0x5EED), 256)
    want = jax.vmap(lambda k: jax.random.randint(k, (), 0, 5))(jks)
    np.testing.assert_array_equal(np.asarray(want),
                                  tdet.randint(tks, (), 0, 5).numpy())


def test_randint_uses_both_words():
    """One word of bits taken modulo the span is not jax's randint: over
    these keys it gives other columns, which the port does not."""
    tks = tdet.split(tdet.master_key(11), 512)
    jks = jax.random.split(jax.random.key(11), 512)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, 5))(
        jks))
    one_word = (tdet.random_bits(tks, ()) % 5).numpy()
    assert (one_word != want).any()
    np.testing.assert_array_equal(tdet.randint(tks, (), 0, 5).numpy(), want)


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        tdet.randint(tdet.master_key(0), (), 0, 2**31)


def _ulps(want, got):
    return (np.abs(want.astype(np.float64) - got)
            / np.spacing(np.abs(want).astype(np.float32)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(4000,), (8, 8, 3, 4)])
def test_normal_within_a_few_ulp(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = tdet.normal(tdet.master_key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert _ulps(want, got.numpy()).max() <= NORMAL_ULP


def test_erfinv_is_xla_s_polynomial():
    """In the tails XLA's erfinv is tens of ulp from the true value; the
    port's follows XLA's, not ``torch.erfinv``."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = np.asarray(jax.random.uniform(jax.random.key(5), (20000,),
                                      minval=lo, maxval=1.0))
    want = np.asarray(jax.scipy.special.erfinv(u))
    got = tdet.erfinv(torch.from_numpy(u.copy())).numpy()
    assert _ulps(want, got).max() <= 2
    edges = np.array([1.0, -1.0, 0.0], np.float32)
    np.testing.assert_array_equal(
        np.asarray(jax.scipy.special.erfinv(edges)),
        tdet.erfinv(torch.from_numpy(edges)).numpy())


# ------------------------------------------------------------------ envs
N_ENVS, STEPS = 6, 30


def _keys(n, t):
    """Transition keys as the rollout derives them, both sides."""
    jm, tm = jax.random.key(3), tdet.master_key(3)
    ids = np.arange(n) + 1_000_003
    jk = jax.vmap(lambda e: jax.random.fold_in(jax.random.fold_in(jm, e),
                                               t))(jnp.asarray(ids))
    return jk, tdet.obs_keys(tm, torch.from_numpy(ids), t)


def _reset_keys(n):
    return (jax.random.split(jax.random.key(3 ^ 0x5EED), n),
            tdet.split(tdet.master_key(3 ^ 0x5EED), n))


def _assert_same(jout, tout):
    (js, jo, *jrd), (ts, to, *trd) = jout, tout
    assert set(js) == set(ts)
    for k in js:
        assert ts[k].dtype == torch.int32, k
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(), k)
    assert to.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    for j, t in zip(jrd, trd):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _drive(jenv, tenv, n=N_ENVS):
    """Reset, then STEPS random actions (three episodes of catch, so every
    env auto-resets at least twice), both sides checked at every step."""
    jk, tk = _reset_keys(n)
    jout, tout = jenv.reset(jk), tenv.reset(tk)
    _assert_same(jout, tout)
    jstep = jax.jit(jenv.step)
    rng = np.random.default_rng(0)
    dones = 0
    for t in range(STEPS):
        a = rng.integers(0, 3, n).astype(np.int32)
        jk, tk = _keys(n, t)
        jout = jstep(jout[0], jnp.asarray(a), jk)
        tout = tenv.step(tout[0], torch.from_numpy(a), tk)
        _assert_same(jout, tout)
        dones += int(tout[3].sum())
    assert dones >= 2 * n


def test_host_env_matches_jax_vectorize():
    _drive(j_vectorize(jcatch.make(), N_ENVS),
           t_vectorize(envs.get_env("catch"), N_ENVS))


def test_device_port_matches_jax_device_port():
    _drive(j_device_env("catch"), envs.get_env("catch_device"))


def test_device_port_matches_jax_host_oracle():
    _drive(j_vectorize(jcatch.make(), N_ENVS), tdevice.get_device_env("catch"))


@pytest.mark.parametrize("n", [1, 5, 64])
def test_port_backends_bit_exact(n):
    host = tdevice.batched_env(envs.get_env("catch"), n, "host")
    dev = tdevice.batched_env(envs.get_env("catch"), n, "device")
    _, tk = _reset_keys(n)
    hs, ho = host.reset(tk)
    ds, do = dev.reset(tk)
    rng = np.random.default_rng(n)
    for t in range(STEPS):
        assert all(torch.equal(hs[k], ds[k]) for k in hs)
        assert torch.equal(ho, do)
        a = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32))
        _, tk = _keys(n, t)
        hs, ho, hr, hd = host.step(hs, a, tk)
        ds, do, dr, dd = dev.step(ds, a, tk)
        assert torch.equal(hr, dr) and torch.equal(hd, dd)


def test_scalar_env_matches_jax():
    jenv, tenv = jcatch.make(), envs.get_env("catch")
    js, jo = jenv.reset(jax.random.key(4))
    ts, to = tenv.reset(tdet.master_key(4))
    _assert_same((js, jo), (ts, to))
    for t in range(12):
        a = t % 3
        js, jo, jr, jd = jenv.step(js, jnp.int32(a), jax.random.key(t))
        ts, to, tr, td = tenv.step(ts, torch.tensor(a, dtype=torch.int32),
                                   tdet.master_key(t))
        _assert_same((js, jo, jr, jd), (ts, to, tr, td))


def test_env_state_bridge_continues_the_episode():
    """A JAX catch state carried into the port steps on identically."""
    jenv = j_vectorize(jcatch.make(), 4)
    tenv = envs.get_env("catch_device")
    jk, _ = _reset_keys(4)
    js, jo = jenv.reset(jk)
    for t in range(4):
        js, jo, _, _ = jenv.step(js, jnp.ones(4, jnp.int32), _keys(4, t)[0])
    ts = bridge.env_state_from_jax(jax.tree.map(np.asarray, js))
    for t in range(4, 14):
        a = np.full(4, t % 3, np.int32)
        jk, tk = _keys(4, t)
        js, jo, jr, jd = jenv.step(js, jnp.asarray(a), jk)
        ts, to, tr, td = tenv.step(ts, torch.from_numpy(a), tk)
        _assert_same((js, jo, jr, jd), (ts, to, tr, td))


def test_env_registry():
    assert envs.env_names() == ["catch", "catch_device", "football",
                                "gridmaze", "gridmaze_device", "token",
                                "token_stream"]
    assert envs.get_env("catch").obs_shape == (10, 5, 1)
    assert envs.get_env("catch_device").host_name == "catch"
    assert envs.get_env("football").obs_shape == (12,)
    assert tdevice.has_device_port("catch")
    assert not tdevice.has_device_port("football")
    with pytest.raises(KeyError, match="registered: \\['catch', "
                       "'catch_device', 'football', 'gridmaze', "
                       "'gridmaze_device', 'token', 'token_stream'\\]"):
        envs.get_env("pong")
    with pytest.raises(ValueError, match="no device-resident port"):
        tdevice.get_device_env("football")


def test_batched_env_backends():
    env1 = envs.get_env("catch")
    assert tdevice.batched_env(env1, 4, "host").name == "catchx4"
    assert tdevice.batched_env(env1, 4, "device").name == "catch@device"
    with pytest.raises(ValueError, match="unknown env_backend"):
        tdevice.batched_env(env1, 4, "tpu")
    assert tdevice.device_port_names() == ["catch", "gridmaze"]
