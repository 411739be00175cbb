"""Port threefry2x32 keys and the Gumbel-argmax sampler vs live jax.random:
integer bits and uniforms bit-exact, Gumbel noise within 2 ulp, actions
equal on fixed seeds."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import determinism as jdet  # noqa: E402
from repro_torch.core import determinism as tdet  # noqa: E402

SEEDS = [0, 1, 3, 7, 42, 12345, 2**31 - 1]


def _jkey(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_master_fold_in_obs_request_keys_bit_exact(seed):
    jm, tm = jdet.master_key(seed), tdet.master_key(seed)
    np.testing.assert_array_equal(_jkey(jm), tm.numpy())
    for d in [0, 1, 5, 1_000_003, 2**31 - 1]:
        np.testing.assert_array_equal(_jkey(jax.random.fold_in(jm, d)),
                                      tdet.fold_in(tm, d).numpy())
        np.testing.assert_array_equal(_jkey(jdet.request_key(jm, d)),
                                      tdet.request_key(tm, d).numpy())
    for env_id, step in [(0, 0), (3, 17), (63, 1000), (1_000_003, 5)]:
        np.testing.assert_array_equal(_jkey(jdet.obs_key(jm, env_id, step)),
                                      tdet.obs_key(tm, env_id, step).numpy())
    env_ids = np.arange(16)
    np.testing.assert_array_equal(
        _jkey(jdet.obs_keys(jm, jnp.asarray(env_ids), 9)),
        tdet.obs_keys(tm, torch.from_numpy(env_ids), 9).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(4,), (512,), (3, 5), (7,)])
def test_bits_and_uniform_bit_exact(seed, shape):
    jk = jdet.obs_key(jdet.master_key(seed), 2, 11)
    tk = tdet.obs_key(tdet.master_key(seed), 2, 11)
    jb = np.asarray(jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(jb, tdet.random_bits(tk, shape).numpy())
    tiny = float(np.finfo(np.float32).tiny)
    ju = np.asarray(jax.random.uniform(jk, shape, jnp.float32, tiny, 1.0))
    tu = tdet.uniform(tk, shape, tiny, 1.0).numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))


def test_batched_keys_match_vmap():
    jm, tm = jdet.master_key(5), tdet.master_key(5)
    jks = jdet.obs_keys(jm, jnp.arange(8), 3)
    tks = tdet.obs_keys(tm, torch.arange(8), 3)
    jb = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (33,), jnp.uint32))(
        jks)).astype(np.int64)
    np.testing.assert_array_equal(jb, tdet.random_bits(tks, (33,)).numpy())


def _ulps(a, b):
    """|a - b| in ulps of max(|a|, 1). -log(-log u) near 0 is the log of
    a value near 1, so there the error is the inner log's (an ulp of ~1),
    not an ulp of the tiny result."""
    scale = np.spacing(np.maximum(np.abs(a), 1.0).astype(np.float32))
    return np.abs(a.astype(np.float64) - b) / scale


def _which_side_moved(jks, tks, jg, tg, ulps) -> str:
    """The worst element's story: each package's own uniforms (from its
    own threefry bits) taken through -log(-log(u)) in float64, beside
    both fp32 results, and each result's distance in ulps from the
    float64 value of its own uniform: the side far from its own exact
    value is the one that moved."""
    tiny = float(np.finfo(np.float32).tiny)
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (512,), jnp.float32, tiny, 1.0))(jks))
    tu = tdet.uniform(tks, (512,), tiny, 1.0).numpy()
    row, col = np.unravel_index(int(np.argmax(ulps)), ulps.shape)
    lines = [f"{int((ulps > 2).sum())} of {ulps.size} values over 2 ulp, "
             f"{int((ulps > 2).any(-1).sum())} of {ulps.shape[0]} key rows; "
             f"the worst at row {row}, column {col}: {ulps[row, col]:.1f} "
             "ulp"]
    for name, u, g in (("jax", ju, jg), ("port", tu, tg)):
        exact = -np.log(-np.log(u[row, col].astype(np.float64)))
        lines.append(
            f"{name}: u {u[row, col]!r} (bits {u[row, col].view(np.uint32)}), "
            f"-log(-log(u)) in float64 {exact!r}, its fp32 result "
            f"{g[row, col]!r}, {_ulps(np.float32(exact), g[row, col]):.1f} "
            "ulp from the float64 value")
    lines.append(f"uniforms equal: {np.array_equal(ju, tu)}")
    return "; ".join(lines)


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_2_ulp(seed):
    jks = jdet.obs_keys(jdet.master_key(seed), jnp.arange(8), 4)
    tks = tdet.obs_keys(tdet.master_key(seed), torch.arange(8), 4)
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (512,)))(jks))
    tg = tdet.gumbel(tks, (512,)).numpy()
    ulps = _ulps(jg, tg)
    if ulps.max() > 2:
        pytest.fail(_which_side_moved(jks, tks, jg, tg, ulps))


@pytest.mark.parametrize("n_actions", [4, 512])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_action_matches(seed, n_actions):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(16, n_actions)).astype(np.float32) * 2.0
    jm, tm = jdet.master_key(seed), tdet.master_key(seed)
    for step in range(4):
        jks = jdet.obs_keys(jm, jnp.arange(16), step)
        tks = tdet.obs_keys(tm, torch.arange(16), step)
        ja = np.asarray(jax.vmap(jdet.sample_action)(jks, jnp.asarray(logits)))
        ta = tdet.sample_action(tks, torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(ja, ta)
    # a single key over a whole (rows, actions) array, as the reference
    # calls it without vmap
    jk, tk = jdet.obs_key(jm, 0, 0), tdet.obs_key(tm, 0, 0)
    np.testing.assert_array_equal(
        np.asarray(jdet.sample_action(jk, jnp.asarray(logits))),
        tdet.sample_action(tk, torch.from_numpy(logits)).numpy())
