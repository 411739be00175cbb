"""The port's checkpoints are the reference's files.

* The manifest's ``treedef`` text equals JAX's ``str(treedef)`` of the
  same capsule, and every leaf's dtype name and shape (conv kernels back
  in HWIO) equal JAX's: mlp on catch and a reduced CNN on gridmaze, K 1
  and 2, with rmsprop, adam and sgd (whose state is ``()``).
* Round trip (bf16 included), corruption raising ``CheckpointCorrupt``,
  torn capsules skipped by ``latest``, structure mismatches raising
  ``ValueError``, ``restore_prefix``.
* Across packages: JAX writes a capsule with ``repro.checkpoint.io`` and
  the port restores it and continues; the port writes one and JAX's own
  ``restore`` (every check on) accepts it against JAX's template and
  continues. Streams exact, params within 1e-5 of the other package
  continuing from the same capsule.
"""
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import models as jmodels  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.core import engine as jengine  # noqa: E402
from repro.envs import get_env as jget_env  # noqa: E402
from repro_torch import bridge, envs, models, optim  # noqa: E402
from repro_torch.checkpoint import io as ckpt_io  # noqa: E402
from repro_torch.core import engine, trainer  # noqa: E402
from repro_torch.core.tree import (tree_leaves,  # noqa: E402
                                   tree_unflatten, treedef_str)

PARAMS_TOL = 1e-5
CNN = dict(conv_filters=(4, 8), conv_sizes=(3, 3), conv_strides=(1, 1),
           hidden=16)
POLICY_ENV = {"mlp": ("catch", {}, {"hidden": 32}),
              "cnn": ("gridmaze", {"scenario_seed": 7}, CNN)}
OPTIMIZERS = {"rmsprop": dict(lr=7e-4, eps=1e-5), "adam": dict(lr=3e-4),
              "sgd": dict(lr=1e-2)}


def _pair(policy, staleness=1, opt="rmsprop", algorithm="a2c"):
    """A JAX mesh runtime and the port's (CPU) from the same params."""
    env_name, env_kw, pol_kw = POLICY_ENV[policy]
    cfg = dict(alpha=4, n_envs=4, seed=3, staleness=staleness,
               algorithm=algorithm)
    jenv = jget_env(env_name, **env_kw)
    jpol = jmodels.get_policy(policy, jenv, **pol_kw)
    jparams = jpol.init(jax.random.key(0))
    jrt = jengine.make_runtime(
        "mesh", jenv, jpol.apply, jparams,
        joptim.get_optimizer(opt, **OPTIMIZERS[opt]),
        jengine.HTSConfig(**cfg))
    env = envs.get_env(env_name, **env_kw)
    pol = models.get_policy(policy, env, **pol_kw)
    rt = engine.make_runtime(
        "mesh", env, pol.apply,
        bridge.policy_params_from_jax(jax.tree.map(np.asarray, jparams)),
        optim.get_optimizer(opt, **OPTIMIZERS[opt]), engine.HTSConfig(**cfg),
        device="cpu")
    return jrt, rt


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("staleness", [1, 2])
@pytest.mark.parametrize("policy", ["mlp", "cnn"])
def test_treedef_dtypes_and_shapes_match_jax(policy, staleness, opt):
    jrt, rt = _pair(policy, staleness, opt)
    jstate = jrt.state()
    ref = trainer.to_disk(rt.state())
    assert treedef_str(ref) == str(jax.tree_util.tree_structure(jstate))
    jleaves = jax.tree_util.tree_leaves(jstate)
    leaves = tree_leaves(ref)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert ckpt_io.dtype_name(a) == str(np.asarray(b).dtype)
        assert a.shape == np.shape(b)
    if opt == "sgd":
        assert rt.state().algo.opt_state == ()


@pytest.mark.parametrize("tree", [
    (1,), (), [], {}, None, 5, [1, (2,), None],
    {"b": {"z": 1, "a": ()}, "a": [None]}, ((), {}),
], ids=repr)
def test_treedef_str_and_unflatten_small_trees(tree):
    assert treedef_str(tree) == str(jax.tree_util.tree_structure(tree))
    leaves = tree_leaves(tree)
    assert leaves == jax.tree_util.tree_leaves(tree)
    assert tree_unflatten(tree, leaves) == tree
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree, leaves + [0])


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"b": torch.randn(3, generator=g),
            "w": torch.randn(4, 3, generator=g),
            "h": torch.randn(2, 2, generator=g).to(torch.bfloat16),
            "n": torch.arange(5, dtype=torch.int32)}


def test_round_trip_keeps_values_and_dtypes(tmp_path):
    path = str(tmp_path / "step_00000001")
    ckpt_io.save(path, _tree(), metadata={"intervals": 1})
    m = ckpt_io.load_manifest(path)
    assert m["version"] == ckpt_io.FORMAT_VERSION
    assert m["dtypes"] == ["float32", "bfloat16", "int32", "float32"]
    assert m["treedef"] == "PyTreeDef({'b': *, 'h': *, 'n': *, 'w': *})"
    assert ckpt_io.load_metadata(path) == {"intervals": 1}
    out = ckpt_io.restore(path, _tree(1))
    for k, want in _tree().items():
        assert out[k].dtype == want.dtype and torch.equal(out[k], want)
    # the manifest dtype is checked against a numpy template too
    np_like = {k: v.float().numpy() if k == "h" else v.numpy()
               for k, v in _tree().items()}
    with pytest.raises(ValueError, match="dtype bfloat16"):
        ckpt_io.restore(path, np_like)


def test_corruption_raises_checkpoint_corrupt(tmp_path):
    path = str(tmp_path / "step_00000001")
    ckpt_io.save(path, _tree())
    with open(path + ".npz", "r+b") as f:
        size = f.seek(0, os.SEEK_END)
        f.truncate(size // 2)
    with pytest.raises(ckpt_io.CheckpointCorrupt):
        ckpt_io.restore(path, _tree())
    # content corruption the zip layer cannot see: the leaf checksum
    path2 = str(tmp_path / "step_00000002")
    ckpt_io.save(path2, _tree())
    arrays = dict(np.load(path2 + ".npz"))
    arrays["leaf_0"] = arrays["leaf_0"] + 1.0
    with open(path2 + ".npz", "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ckpt_io.CheckpointCorrupt, match="checksum"):
        ckpt_io.restore(path2, _tree())
    assert not issubclass(ckpt_io.CheckpointCorrupt, ValueError)


def test_latest_skips_torn_capsules(tmp_path):
    for i in (1, 2, 3):
        ckpt_io.save(str(tmp_path / f"step_{i:08d}"), _tree(i))
    os.remove(tmp_path / "step_00000003.npz")        # manifest, no npz
    os.remove(tmp_path / "step_00000002.json")       # npz, no manifest
    assert ckpt_io.complete_checkpoints(str(tmp_path)) == [
        str(tmp_path / "step_00000001")]
    assert ckpt_io.latest(str(tmp_path)) == str(tmp_path / "step_00000001")
    assert ckpt_io.latest(str(tmp_path / "absent")) is None
    with pytest.raises(ckpt_io.CheckpointCorrupt, match="torn"):
        ckpt_io.restore(str(tmp_path / "step_00000003"), _tree())


def test_structure_mismatches_raise_value_error(tmp_path):
    path = str(tmp_path / "step_00000001")
    ckpt_io.save(path, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ckpt_io.restore(path, {"b": _tree()["b"]})
    renamed = dict(_tree())
    renamed["z"] = renamed.pop("w")
    with pytest.raises(ValueError, match="tree structure mismatch"):
        ckpt_io.restore(path, renamed)
    ring = dict(_tree())
    ring["w"] = torch.stack([ring["w"]] * 2)
    with pytest.raises(ValueError, match="ring"):
        ckpt_io.restore(path, ring)


def test_restore_prefix(tmp_path):
    jrt, rt = _pair("cnn", staleness=2)
    path = str(tmp_path / "step_00000000")
    state = rt.state()
    ckpt_io.save(path, trainer.to_disk(state))
    params_ref = bridge.policy_params_to_reference(state.algo.params)
    got = ckpt_io.restore_prefix(path, params_ref)
    for k, v in params_ref.items():
        np.testing.assert_array_equal(got[k], v)
    assert got["conv0_w"].shape == (3, 3, 3, 4)            # HWIO on disk
    with pytest.raises(ValueError, match="shape"):
        ckpt_io.restore_prefix(path, {k: v.T if v.ndim == 2 else v
                                      for k, v in params_ref.items()})
    os.remove(path + ".json")
    with pytest.raises(ValueError, match="no manifest"):
        ckpt_io.restore_prefix(path, params_ref)


def _assert_close_params(params, jparams):
    ref = bridge.policy_params_to_reference(params)
    for k, v in jparams.items():
        diff = np.abs(ref[k] - np.asarray(v)).max()
        assert diff <= PARAMS_TOL, (k, diff)


@pytest.mark.parametrize("policy,staleness", [("mlp", 1), ("cnn", 2)])
def test_jax_writes_port_restores_and_continues(tmp_path, policy,
                                                staleness):
    jrt, rt = _pair(policy, staleness)
    jrt.run(3)
    jstate = jrt.state()
    path = str(tmp_path / "step_00000003")
    jio.save(path, jstate, metadata={"intervals": 3})
    state = trainer.restore_capsule(path, rt.state())
    assert int(state.interval) == 3
    out = rt.run_from(state, 3)
    jout = jrt.run_from(jstate, 3)
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    assert int(out.state.step) == int(jout.state.step)
    _assert_close_params(out.params, jout.params)


@pytest.mark.parametrize("policy,staleness", [("mlp", 2), ("cnn", 1)])
def test_port_writes_jax_restores_and_continues(tmp_path, policy,
                                                staleness):
    jrt, rt = _pair(policy, staleness, algorithm="ppo")
    rt.run(3)
    state = rt.state()
    path = str(tmp_path / "step_00000003")
    ckpt_io.save(path, trainer.to_disk(state), metadata={"intervals": 3})
    manifest = json.loads(open(path + ".json").read())
    assert manifest["treedef"] == str(
        jax.tree_util.tree_structure(jrt.state()))
    jstate = jio.restore(path, jrt.state())        # every check of JAX's
    assert int(jstate.interval) == 3
    jout = jrt.run_from(jstate, 3)
    out = rt.run_from(state, 3)
    np.testing.assert_array_equal(out.rewards, jout.rewards)
    np.testing.assert_array_equal(out.dones, jout.dones)
    _assert_close_params(out.params, jout.params)
