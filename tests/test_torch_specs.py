"""The port's input specs (``repro_torch.launch.specs``, tensors on
``meta``) against the reference's ``ShapeDtypeStruct``s
(``repro.launch.specs``) for every arch x shape: each input's shape and
dtype, the decode cache layer by layer (the reference's stacked leading
dim dropped), and ``supports`` / ``skip_reason``."""
from __future__ import annotations

import jax
import pytest

from repro.configs.base import get_config as ref_config
from repro.configs.base import list_configs
from repro.launch import specs as ref_specs
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.launch import specs


def _sig(x) -> tuple:
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    return tuple(x.shape), str(x.dtype).replace("torch.", "")


class _Stacked:
    """A stacked reference leaf: indexing by the block drops the block
    dim from its signature."""

    def __init__(self, x):
        self.sig = _sig(x)

    def __getitem__(self, b):
        shape, dtype = self.sig
        return shape[1:], dtype


def _stacked(tree, stacked=False):
    if isinstance(tree, dict):
        return {k: _stacked(v, stacked or k == "blocks")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stacked(v, stacked) for v in tree]
    return _Stacked(tree) if stacked else _sig(tree)


def _sigs(d: dict) -> dict:
    return {k: _sig(v) for k, v in d.items()}


@pytest.mark.parametrize("shape_name", list(specs.SHAPES))
@pytest.mark.parametrize("arch", list_configs())
def test_specs_equal_the_reference(arch, shape_name):
    cfg, rcfg = get_config(arch), ref_config(arch)
    shape, rshape = specs.SHAPES[shape_name], ref_specs.SHAPES[shape_name]
    assert tuple(shape) == tuple(rshape)
    assert specs.supports(cfg, shape_name) == ref_specs.supports(
        rcfg, shape_name)
    assert specs.skip_reason(cfg, shape_name) == ref_specs.skip_reason(
        rcfg, shape_name)
    if not specs.supports(cfg, shape_name):
        return
    if shape.kind != "decode":
        mine, ref = ((specs.train_batch_specs, ref_specs.train_batch_specs)
                     if shape.kind == "train" else
                     (specs.prefill_batch_specs,
                      ref_specs.prefill_batch_specs))
        got = mine(cfg, shape)
        assert _sigs(got) == _sigs(ref(rcfg, rshape))
        assert all(t.device.type == "meta" for t in got.values())
    else:
        token, cache, pos, extras = specs.decode_specs(cfg, shape)
        rtoken, rcache, rpos, rextras = ref_specs.decode_specs(rcfg, rshape)
        assert _sig(token) == _sig(rtoken) and _sig(pos) == _sig(rpos)
        assert _sigs(extras) == _sigs(rextras)
        assert all(t.device.type == "meta"
                   for layer in cache for t in layer.values())
        want = bridge.unstack_layers(_stacked(rcache), cfg)
        assert [_sigs(layer) for layer in cache] == want


def test_reference_stacks_what_the_port_lists():
    """The comparison above is not vacuous: the reference's cache is
    stacked (one leaf per cycle position), the port's one dict a layer."""
    cfg = get_config("gemma2-27b")
    _, cache, _, _ = specs.decode_specs(cfg, specs.SHAPES["decode_32k"])
    _, rcache, _, _ = ref_specs.decode_specs(ref_config("gemma2-27b"),
                                             ref_specs.SHAPES["decode_32k"])
    assert len(cache) == cfg.n_layers
    assert jax.tree.leaves(rcache)[0].shape[0] == cfg.n_layers // 2
