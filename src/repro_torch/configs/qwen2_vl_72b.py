"""Qwen2-VL 72B (language backbone). [arXiv:2409.12191]

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, M-RoPE (3
position streams: temporal/height/width). The vision tower is a stub, as
in the reference: callers pass ``patch_embeds`` of (B, 256, d_model),
written over the first 256 positions. Counterpart of
``repro/configs/qwen2_vl_72b.py``.
"""
from repro_torch.configs.base import ModelConfig, register, ATTN_FULL

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    mixer_cycle=(ATTN_FULL,),
    mrope=True,
    vision_prefix=256,            # merged patch-embedding prefix length
    sub_quadratic=False,
    source="arXiv:2409.12191",
))
