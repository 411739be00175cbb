"""The port's roofline (``repro_torch.roofline``) against the
reference's: ``count_params`` and ``model_flops_for`` for every arch and
shape kind, ``build_roofline``'s three terms on the H100 constants by
hand, and ``op_cost``'s FLOPs of a reduced StarCoder2-3B prefill on the
CPU against ``hlo_cost.analyze`` of the same step lowered by XLA on the
CPU, both through ``blocked_attention``."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.configs.base import list_configs
from repro.core import learner as ref_learner
from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_cost
from repro_torch.configs.base import get_config
from repro_torch.core import learner
from repro_torch.launch import mesh, specs
from repro_torch.models import backbone
from repro_torch.roofline import analysis
from repro_torch.roofline.op_cost import OpCost

B, S = 2, 64


@pytest.mark.parametrize("arch", list_configs())
def test_params_and_model_flops_equal_the_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert analysis.count_params(cfg) == ref_analysis.count_params(rcfg)
    for shape in specs.SHAPES.values():
        args = (shape.kind, shape.seq_len, shape.global_batch)
        assert analysis.model_flops_for(cfg, *args) == \
            ref_analysis.model_flops_for(rcfg, *args)


def test_build_roofline_terms_by_hand():
    cost = {"flops": 2 * mesh.PEAK_FLOPS_BF16, "bytes accessed": 3.0e12}
    coll = {"bytes_by_op": {"all-gather": 9e11, "all-reduce": 1e11},
            "nvlink_bytes": 9e11, "ib_bytes": 1e11}
    r = analysis.build_roofline("a", "s", "pod", 256, cost, coll,
                                model_flops=1e17, peak_memory=1e9)
    assert r.compute_s == pytest.approx(2.0)
    assert r.memory_s == pytest.approx(3.0e12 / 3.35e12)
    assert r.collective_s == pytest.approx(9e11 / 450e9 + 1e11 / 50e9)
    assert r.collective_s == pytest.approx(4.0)
    assert r.bottleneck == "collective"
    assert r.collective_bytes_per_chip == 1e12
    assert r.useful_flops_ratio == pytest.approx(
        1e17 / (2 * mesh.PEAK_FLOPS_BF16 * 256))
    assert analysis.mfu(1e15, 1.0) == pytest.approx(1e15 / 989.4e12)
    cost["bytes accessed"] = 2e13
    assert analysis.build_roofline("a", "s", "pod", 1, cost, coll, 1.0,
                                   0.0).bottleneck == "memory"


def test_op_cost_flops_equal_hlo_cost_on_a_reduced_prefill():
    """The port's op-by-op count of one prefill step and the reference's
    loop-aware HLO count of the same step agree within 1 %: both count
    2 per multiply-add of every product (projections, the attention
    tiles, the MLP, the heads); elementwise work counts in neither."""
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              dtype="float32")
    rcfg = dataclasses.replace(ref_config("starcoder2-3b").reduced(),
                               dtype="float32")
    assert not cfg.use_pallas_attention and not rcfg.use_pallas_attention
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    params = dict(backbone.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu").named_parameters())
    step = learner.make_prefill_step(cfg, S)
    with torch.no_grad(), OpCost() as oc:
        step(params, {"tokens": torch.as_tensor(tokens, dtype=torch.int32)})

    from repro.models import backbone as ref_backbone
    abstract = ref_backbone.abstract_params(rcfg)
    lowered = jax.jit(ref_learner.make_prefill_step(rcfg, S)).lower(
        abstract, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)})
    ref = hlo_cost.analyze(lowered.compile().as_text())
    assert ref.flops > 0
    assert oc.flops == pytest.approx(ref.flops, rel=0.01), \
        (oc.flops, ref.flops)
