"""The port's sharding rules (``repro_torch.sharding.rules``) against the
reference's (``repro.sharding.rules``) on the same inputs: ``resolve``,
``batch_pspec`` and ``_kv_cache_spec`` on four mesh shapes, every
parameter leaf of every registered arch at full width, and the decode
caches under ``decode_32k`` and ``long_500k``. The meshes are stand-ins
(axis names and sizes), as in ``tests/test_sharding.py``."""
from __future__ import annotations

import itertools
import types

import jax
import numpy as np
import pytest

from repro.configs.base import get_config as ref_config
from repro.configs.base import list_configs
from repro.models import backbone as ref_backbone
from repro.sharding import rules as ref_rules
from repro_torch import bridge
from repro_torch.configs.base import get_config
from repro_torch.launch import specs
from repro_torch.models import backbone
from repro_torch.sharding import rules
from repro_torch.sharding.constraints import constrained_spec

MESH_SHAPES = {
    "v5e_pod": ((16, 16), ("data", "model")),
    "v5e_multipod": ((2, 16, 16), ("pod", "data", "model")),
    "h100_pod": ((32, 8), ("data", "model")),
    "h100_multipod": ((2, 32, 8), ("pod", "data", "model")),
}


class StandIn:
    """A mesh as both rule sets read one: the reference's ``axis_names``
    and ``devices.shape``, the port's ``mesh_dim_names`` and ``shape``."""

    def __init__(self, shape, names):
        self.axis_names = self.mesh_dim_names = names
        self.shape = shape
        self.devices = types.SimpleNamespace(shape=shape,
                                             size=int(np.prod(shape)))


MESHES = {k: StandIn(*v) for k, v in MESH_SHAPES.items()}


def _norm(spec) -> tuple:
    """A spec as a plain tuple, trailing Nones trimmed."""
    out = [tuple(e) if isinstance(e, (list, tuple)) else e for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class _Stacked:
    """A reference spec of a scan-stacked leaf: indexing by the block
    drops its leading (block) entry, as the port's per-layer leaf has no
    such dim."""

    def __init__(self, spec):
        self.spec = tuple(spec)

    def __getitem__(self, b):
        return self.spec[1:]


def _stack_marked(tree, stacked=False):
    if isinstance(tree, dict):
        return {k: _stack_marked(v, stacked or k in ("blocks", "layers"))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stack_marked(v, stacked) for v in tree]
    return _Stacked(tree) if stacked else tree


LOGICAL = [("embed", "ffn"), ("batch", None, None), ("vocab", "embed"),
           ("batch", "seq_model", None), ("batch", "experts", None, None),
           ("heads", "head_dim", "embed"), ("embed", "kv_heads", "head_dim"),
           ("batch", "heads", None, None), ("batch", None, "dsq"),
           ("seq_data", None), ("frames", "embed")]
SIZES = [1, 2, 4, 8, 16, 24, 32, 40, 48, 64, 128, 256, 512, 3072, 4096]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_resolve_and_batch_equal_the_reference(mesh):
    m = MESHES[mesh]
    rng = np.random.default_rng(0)
    cases = [(("embed", "ffn"), (4096, 16384)), (("heads",), (40,)),
             (("batch", None), (1, 4)), (("batch", "batch"), (512, 512)),
             (("heads", "head_dim"), (40, 128))]
    for logical in LOGICAL:
        for _ in range(12):
            cases.append((logical, tuple(int(rng.choice(SIZES))
                                         for _ in logical)))
    for logical, shape in cases:
        want = _norm(ref_rules.resolve(logical, shape, m))
        assert _norm(rules.resolve(logical, shape, m)) == want, \
            (logical, shape)
    for b in SIZES + [1024, 96, 6]:
        assert rules.batch_pspec(m, b) == ref_rules.batch_pspec(m, b), b


@pytest.mark.parametrize("mesh", list(MESHES))
def test_kv_cache_spec_equals_the_reference(mesh):
    m = MESHES[mesh]
    for B, S, KV, Dh in itertools.product((1, 8, 32, 128, 256),
                                          (4096, 32768, 524288, 1500),
                                          (1, 2, 8, 16, 40), (64, 120, 128)):
        want = _norm(ref_rules._kv_cache_spec((B, S, KV, Dh), m, False))
        got = _norm(rules._kv_cache_spec((B, S, KV, Dh), m))
        assert got == want, (B, S, KV, Dh)


def test_placements_of_specs():
    """``to_placements``: a dim over two axes is ``Shard(d)`` on both mesh
    dims; ``as_placements`` maps a spec tree; ``local_shape`` divides."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import as_placements
    m = MESHES["h100_multipod"]
    spec = rules.P(("pod", "data"), None, "model")
    assert rules.to_placements(spec, m) == (Shard(0), Shard(0), Shard(2))
    assert rules.to_placements(rules.P(), m) == (Replicate(),) * 3
    tree = {"a": spec, "b": [rules.P(None, "data")]}
    assert as_placements(m, tree) == {
        "a": (Shard(0), Shard(0), Shard(2)),
        "b": [(Replicate(), Shard(1), Replicate())]}
    assert rules.local_shape((256, 4096, 64), spec, m) == (4, 4096, 8)


def test_constrain_resolution_skips_unit_axes():
    """``constrain`` assigns no axis group of size 1 (the reference's
    ``total > 1``), where ``resolve`` would."""
    m = StandIn((1, 8), ("data", "model"))
    assert _norm(constrained_spec((4, 64, 16), ("batch", "seq_model", None),
                                  m)) == (None, "model")
    assert _norm(rules.resolve(("batch", "seq_model", None), (4, 64, 16),
                               m)) == ("data", "model")


@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_equal_the_reference(arch):
    """Every leaf at full width, on all four meshes: the reference's spec
    with its stacked leading dim dropped, named through the bridge."""
    params = dict(backbone.Backbone(get_config(arch),
                                    device="meta").named_parameters())
    abstract = ref_backbone.abstract_params(ref_config(arch))
    for name, m in MESHES.items():
        ref = bridge.reference_flat(
            _stack_marked(ref_rules.param_pspecs(abstract, m)),
            get_config(arch))
        ref = {k: v.spec if isinstance(v, _Stacked) else v
               for k, v in ref.items()}
        got = rules.param_specs(params, m)
        assert set(got) == set(ref)
        bad = {k: (_norm(got[k]), _norm(ref[k])) for k in got
               if _norm(got[k]) != _norm(ref[k])}
        assert not bad, (name, bad)


@pytest.mark.parametrize("arch", list_configs())
def test_cache_and_batch_specs_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape_name in ("decode_32k", "long_500k"):
        if not specs.supports(cfg, shape_name):
            continue
        shape = specs.SHAPES[shape_name]
        B, S = shape.global_batch, shape.seq_len
        cache = backbone.init_decode_cache(cfg, B, S, device="meta")
        ref_cache = jax.eval_shape(
            lambda: ref_backbone.init_decode_cache(rcfg, B, S))
        for name, m in MESHES.items():
            ref = bridge.unstack_layers(
                _stack_marked(ref_rules.cache_pspecs(ref_cache, rcfg, m)),
                cfg)
            got = rules.cache_specs(cache, cfg, m)
            assert [{k: _norm(v) for k, v in layer.items()}
                    for layer in got] == \
                [{k: _norm(v) for k, v in layer.items()} for layer in ref], \
                (shape_name, name)
            token, _, _, extras = specs.decode_specs(cfg, shape)
            batch = {"tokens": token, **extras}
            ref_b = ref_rules.batch_specs(
                {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32)
                 for k, v in batch.items()}, m)
            assert {k: _norm(v) for k, v in
                    rules.batch_specs(batch, m).items()} == \
                {k: _norm(v) for k, v in ref_b.items()}
