"""StarCoder2-3B. [arXiv:2402.19173]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152, GQA + RoPE.
Counterpart of ``repro/configs/starcoder2_3b.py``.
"""
from repro_torch.configs.base import ModelConfig, register, ATTN_FULL

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    mixer_cycle=(ATTN_FULL,),
    mlp_kind="gelu",
    norm_kind="layernorm",
    sub_quadratic=False,
    source="arXiv:2402.19173",
))
