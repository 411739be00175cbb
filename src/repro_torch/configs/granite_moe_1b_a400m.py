"""IBM Granite-3.0 1B-a400m MoE. [hf:ibm-granite/granite-3.0-1b-a400m-base]

24L d_model=1024 16H (GQA kv=8) d_ff=512 (expert) vocab=49155,
MoE 32 experts top-8. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register, ATTN_FULL, FFN_MOE

CONFIG = register(ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    mixer_cycle=(ATTN_FULL,),
    ffn_cycle=(FFN_MOE,),
    n_experts=32,
    top_k=8,
    sub_quadratic=False,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
