"""RecurrentGemma-9B (Griffin). [arXiv:2402.19427]

38L d_model=4096 16H (GQA kv=1, MQA) d_ff=12288 vocab=256000.
Pattern: (RG-LRU, RG-LRU, local attention) 1:2, window 2048.
Counterpart of ``repro/configs/recurrentgemma_9b.py``.
"""
from repro_torch.configs.base import (ModelConfig, register, ATTN_LOCAL,
                                      RGLRU, FFN_DENSE)

CONFIG = register(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    mixer_cycle=(RGLRU, RGLRU, ATTN_LOCAL),
    ffn_cycle=(FFN_DENSE,),
    window=2048,
    mlp_kind="gelu",               # GeGLU in the paper; gated gelu here
    sub_quadratic=True,
    source="arXiv:2402.19427",
))
