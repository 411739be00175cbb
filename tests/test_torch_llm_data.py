"""The LLM slice's data against live JAX, exactly.

* ``determinism.permutation`` against ``jax.random.permutation`` at the
  vocabularies of the token workloads (17 and 512 as in the tests and
  the reduced configs, 49152 StarCoder2's, 65536 RWKV-6's, 256000
  RecurrentGemma's, where 32-bit sort keys tie a few times per round and
  only a stable sort gives jax's order), seeds 0-3.
* ``data.pipeline.TokenStream`` batches at several steps and after
  ``skip``; ``traj_to_batch`` on a rollout-shaped trajectory.
* ``envs.token_env``: reset and the step stream through auto-resets.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipeline  # noqa: E402
from repro.envs import token_env as jtoken  # noqa: E402
from repro_torch import envs  # noqa: E402
from repro_torch.core import determinism  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402


@pytest.mark.parametrize("vocab", [17, 512, 49152, 65536, 256000])
def test_permutation_matches_jax(vocab):
    for seed in range(4):
        want = np.asarray(jax.random.permutation(jax.random.key(seed),
                                                 jnp.arange(vocab)))
        got = determinism.permutation(determinism.master_key(seed), vocab)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


def test_permutation_of_a_tensor_and_ties_need_a_stable_sort():
    x = torch.arange(100, 300, dtype=torch.int32)
    want = np.asarray(jax.random.permutation(jax.random.key(9),
                                             jnp.arange(100, 300)))
    np.testing.assert_array_equal(
        determinism.permutation(determinism.master_key(9), x).numpy(), want)
    # at vocab 256000 the round's 32-bit keys do tie
    key, sub = determinism.split(determinism.master_key(1), 2)
    bits = determinism.random_bits(sub, (256000,))
    assert bits.unique().numel() < 256000


def _assert_batch(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == getattr(torch, str(w.dtype)), k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


@pytest.mark.parametrize("vocab,seed", [(512, 0), (65536, 2), (256000, 1)])
def test_token_stream_batches_and_skip(vocab, seed):
    ref = jpipeline.TokenStream(vocab, 3, 20, seed)
    port = pipeline.TokenStream(vocab, 3, 20, seed)
    for _ in range(2):
        _assert_batch(port.next_batch(), ref.next_batch())
    ref.skip(5)
    port.skip(5)
    _assert_batch(port.next_batch(), ref.next_batch())
    # fast-forward is resume: a fresh stream skipped to step 8
    _assert_batch(pipeline.TokenStream(vocab, 3, 20, seed).skip(8)
                  .next_batch(), ref.next_batch())


def test_token_env_streams_match_jax():
    vocab, horizon = 256, jtoken.HORIZON
    ref, port = jtoken.make(vocab, seed=2), envs.get_env("token", vocab=vocab,
                                                         seed=2)
    assert (port.obs_shape, port.n_actions) == (ref.obs_shape, ref.n_actions)
    rs, robs = ref.reset(jax.random.key(4))
    ps, pobs = port.reset(determinism.master_key(4))
    assert int(pobs) == int(robs)
    rng = np.random.default_rng(0)
    for t in range(2 * horizon + 3):
        # the right next token half the time, so rewards are not all 0
        nxt = int(np.asarray(ref.step(rs, jnp.int32(0),
                                      jax.random.key(0))[1]))
        a = nxt if rng.random() < 0.5 else int(rng.integers(vocab))
        rs, robs, rr, rd = ref.step(rs, jnp.int32(a), jax.random.key(t))
        ps, pobs, pr, pd = port.step(ps, torch.tensor(a, dtype=torch.int32),
                                     determinism.master_key(t))
        assert (int(pobs), float(pr), float(pd)) == \
            (int(robs), float(rr), float(rd)), t
        assert int(ps["t"]) == int(rs["t"]) and int(ps["tok"]) == int(
            rs["tok"])


@pytest.mark.parametrize("use_gae", [True, False])
def test_traj_to_batch_matches_jax(use_gae):
    rng = np.random.default_rng(3)
    T, N = 6, 3
    traj = {"obs": rng.integers(0, 50, (T, N)).astype(np.int32),
            "actions": rng.integers(0, 50, (T, N)).astype(np.int32),
            "rewards": rng.normal(size=(T, N)).astype(np.float32),
            "dones": (rng.random((T, N)) < 0.2).astype(np.float32),
            "behavior_logprob": rng.normal(size=(T, N)).astype(np.float32)}
    values = rng.normal(size=(T, N)).astype(np.float32)
    boot = rng.normal(size=(N,)).astype(np.float32)
    want = jpipeline.traj_to_batch(traj, values, boot, use_gae=use_gae)
    got = pipeline.traj_to_batch({k: torch.from_numpy(v)
                                  for k, v in traj.items()},
                                 torch.from_numpy(values),
                                 torch.from_numpy(boot), use_gae=use_gae)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)
