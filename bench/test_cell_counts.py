"""The FLOP and byte counters against counts made by hand at small
shapes."""
import pytest
import torch

from benchlib import counts, tiny
from reference import model as ref_model


def test_bound_is_the_larger_time():
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 989.4e12) == pytest.approx(1.0)
    assert counts.bound_s(3.35e12, 2 * 989.4e12) == pytest.approx(2.0)


def test_flash_counts_by_hand():
    # B 1, S 3, H 2, KV 1, Dh 4: pairs kept 1 + 2 + 3 = 6
    n_bytes, ops = counts.flash_fwd(1, 3, 2, 1, 4)
    q = 3 * 2 * 4 * 2
    kv = 2 * 3 * 1 * 4 * 2
    assert n_bytes == q + kv + q + 2 * 3 * 4
    assert ops == 2 * 2 * 2 * 6 * 4          # 2 products x 2 FLOP
    n_bytes, ops = counts.flash_bwd(1, 3, 2, 1, 4)
    assert n_bytes == (q + kv + 2 * q + 2 * 3 * 4) + (q + kv)
    assert ops == 5 * 2 * 2 * 6 * 4


def test_wkv6_counts_by_hand():
    # B 1, T 2, H 1, N 2
    n_bytes, ops = counts.wkv6_fwd(1, 2, 1, 2)
    x = 1 * 2 * 1 * 2
    assert ops == 2 * (5 * 4 + 5 * 2)
    assert n_bytes == 3 * x * 2 + x * 4 + 2 * 4 + x * 2 + 4 * 4
    n_bytes, ops = counts.wkv6_bwd(1, 2, 1, 2)
    assert ops == 2 * 2 * (5 * 4 + 5 * 2)
    assert n_bytes == 2 * (3 * x * 2 + x * 4 + 2 * 4) + x * 2 + 2 * 4 * 4


@pytest.mark.parametrize("arch", ["starcoder2-3b", "rwkv6-7b"])
def test_matmul_params_are_the_references_matrices(arch):
    cfg = tiny.config(arch)
    # every 2-D or 3-D leaf but the embedding table and the per-head or
    # per-stream vectors (mu (5, d), u and ln_scale (H, N))
    vectors = ("embed", ".mu", ".u", ".ln_scale")
    mats = sum(torch.Size(shape).numel()
               for name, shape, _, _ in ref_model.param_specs(cfg)
               if len(shape) >= 2 and not name.endswith(vectors))
    assert counts.matmul_params(cfg) == mats


def test_step_flops_at_a_small_shape():
    cfg = {"architecture": "starcoder2", "hidden_size": 8,
           "num_hidden_layers": 1, "vocab_size": 10, "intermediate_size": 16,
           "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4}
    weights = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 2 * 8 * 16 + 8 * 10 + 8
    attention = 2 * 2 * 2 * 3 * 4            # B 1, S 2: 3 pairs, 2 heads
    assert counts.step_model_flops(cfg, 1, 2) == 3 * (2 * weights * 2
                                                      + attention)
