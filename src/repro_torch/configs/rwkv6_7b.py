"""RWKV-6 (Finch) 7B. [arXiv:2404.05892]

32L d_model=4096 attention-free (WKV6 time-mix, 64-dim heads) d_ff=14336
vocab=65536. Data-dependent decay, O(1) decode state.
Counterpart of ``repro/configs/rwkv6_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, register, RWKV, FFN_DENSE

CONFIG = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                   # 4096 / 64-dim heads
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    mixer_cycle=(RWKV,),
    mlp_kind="gelu",              # the reference's stand-in for channel-mix
    sub_quadratic=True,
    source="arXiv:2404.05892",
))
