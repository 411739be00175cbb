"""H2O Danube3 4B. [arXiv:2401.16818]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, llama+mistral mix
with sliding-window attention -> sub-quadratic, runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, register, ATTN_LOCAL, FFN_DENSE

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    mixer_cycle=(ATTN_LOCAL,),
    window=4096,
    sub_quadratic=True,
    source="arXiv:2401.16818",
))
