"""The benchmark's fp32 reference against the port's plain CPU path, on
the reduced StarCoder2 and RWKV-6 configs in float32: one step's loss
and every leaf's gradient, on the same weights and batch."""
import pytest
import torch

from benchlib import rollouts, tiny, weights
from reference import model as ref_model


@pytest.mark.parametrize("arch", ["starcoder2-3b", "rwkv6-7b"])
def test_reference_matches_the_ports_plain_path(arch):
    from repro_torch.core import learner
    cfg = tiny.config(arch, dtype="float32")
    theta = weights.make(ref_model.param_specs(cfg), 3, "cpu")
    batch = rollouts.on_device(
        rollouts.batches(tiny.TRAFFIC, cfg["vocab_size"], 3), "cpu")[1]
    leaves = {n: t.clone().requires_grad_() for n, t in theta.items()}
    st, _ = learner.rl_loss_parts(leaves, tiny.port_config(arch, "float32"),
                                  batch, "a2c")
    want = dict(zip(leaves, torch.autograd.grad(st.total,
                                                list(leaves.values()))))
    got = {}
    loss = ref_model.Reference(cfg, theta, lr=1e-4).step(
        batch, lambda n, g: got.__setitem__(n, g))["loss"]
    assert loss == pytest.approx(float(st.total.detach()), rel=1e-5)
    assert set(got) == set(want)
    for n, g in want.items():
        scale = float(g.abs().max()) + 1e-12
        assert float((got[n] - g).abs().max()) <= 1e-4 * scale, n
