"""Whisper medium (decoder backbone + encoder). [arXiv:2212.04356]

24L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865, encoder-decoder:
24 encoder layers over 1500 precomputed frame embeddings (the conv/mel
frontend is a stub, as in the reference: callers pass ``audio_embeds``
of (B, 1500, d_model)) and a cross-attention sublayer in each decoder
layer. Counterpart of ``repro/configs/whisper_medium.py``.
"""
from repro_torch.configs.base import ModelConfig, register, ATTN_FULL

CONFIG = register(ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mixer_cycle=(ATTN_FULL,),
    mlp_kind="gelu",
    norm_kind="layernorm",
    is_encoder_decoder=True,
    n_enc_layers=24,
    enc_seq=1500,
    sub_quadratic=False,
    source="arXiv:2212.04356",
))
