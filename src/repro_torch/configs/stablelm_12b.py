"""StableLM-2 12B. [hf:stabilityai/stablelm-2-1_6b (family card)]

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register, ATTN_FULL, FFN_DENSE

CONFIG = register(ModelConfig(
    name="stablelm-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab_size=100352,
    mixer_cycle=(ATTN_FULL,),
    norm_kind="layernorm",
    sub_quadratic=False,
    source="hf:stabilityai/stablelm-2-1_6b",
))
