"""The traffic is a pure function of the seed, and packs whole episodes:
each row's real tokens come first, advantages are zero-mean within an
episode, padding is out of the loss."""
import numpy as np

from benchlib import rollouts, tiny

SEED = 2 ** 31 + 11


def test_same_seed_same_batches_other_seed_others():
    a = rollouts.batches(tiny.TRAFFIC, 512, SEED)
    b = rollouts.batches(tiny.TRAFFIC, 512, SEED)
    c = rollouts.batches(tiny.TRAFFIC, 512, SEED + 1)
    assert len(a) == tiny.TRAFFIC["pool"]
    for x, y in zip(a, b):
        assert x.keys() == set(rollouts.FIELDS)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["tokens"], c[0]["tokens"])


def test_rows_pack_episodes_and_padding_is_masked():
    p = dict(tiny.TRAFFIC, seq=200, batch=3)
    for b in rollouts.batches(p, 512, SEED):
        assert b["tokens"].shape == (3, 200)
        np.testing.assert_array_equal(b["actions"][:, :-1],
                                      b["tokens"][:, 1:])
        m = b["loss_mask"]
        # real tokens first, padding after
        assert (np.diff(m, axis=1) <= 0).all()
        assert m.sum() > 0.5 * m.size
        for k in ("advantages", "returns"):
            assert (b[k][m == 0] == 0).all()
        assert ((0 <= b["tokens"]) & (b["tokens"] < 512)).all()
