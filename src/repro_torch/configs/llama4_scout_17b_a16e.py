"""Llama-4 Scout 17B-active 16-expert MoE. [hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (expert) vocab=202048, MoE 16e
top-1 with a shared expert, interleaved chunked-local attention (iRoPE):
3 local (8192-token chunk) layers then 1 global NoPE layer.
long_500k is skipped: the global layers are full-attention.
"""
from repro_torch.configs.base import (ModelConfig, register, ATTN_FULL, ATTN_LOCAL,
                                FFN_MOE)

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mixer_cycle=(ATTN_LOCAL, ATTN_LOCAL, ATTN_LOCAL, ATTN_FULL),
    ffn_cycle=(FFN_MOE,),
    window=8192,
    rope_on_global=False,          # iRoPE: NoPE on global layers
    n_experts=16,
    top_k=1,
    shared_expert=True,
    sub_quadratic=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
