"""Gemma-2 27B. [arXiv:2408.00118]

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000,
local(4096)+global alternating, attention logit softcap 50, final softcap 30.
Sliding-window variant implemented -> runs long_500k (global layers keep the
full cache; local layers use the window).
"""
from repro_torch.configs.base import (ModelConfig, register, ATTN_FULL, ATTN_LOCAL,
                                FFN_DENSE)

CONFIG = register(ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    mixer_cycle=(ATTN_LOCAL, ATTN_FULL),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    mlp_kind="gelu",
    sub_quadratic=True,
    source="arXiv:2408.00118",
))
