"""Decoder backbone: embed, a stack of decoder layers, final norm, LM and
value heads.

Counterpart of ``repro/models/backbone.py`` for decoders of ATTN_FULL,
ATTN_LOCAL, RGLRU and RWKV mixers with the dense FFN. The reference
stacks each mixer/ffn cycle's params under ``blocks/l<i>``, scans over
them and runs the left-over layers (``rem``) unrolled; here each layer is
one ``DecoderLayer`` in an ``nn.ModuleList`` (``bridge.py`` unstacks), so
the cycle exists only in the bridge. Modules hold the weights; the config
is passed on each call, as the reference passes it beside the params, so
one set of weights can run with and without the kernels.

Entry points: ``forward`` (full sequence, optionally filling caches),
``prefill`` and ``decode_step``; ``init_params`` builds the model on the
device from a ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import (ATTN_FULL, ATTN_LOCAL, FFN_DENSE,
                                      RGLRU, RWKV, ModelConfig)
from repro_torch.models import attention, layers, rglru, rwkv6

_NOT_PORTED = ("not ported yet: the port's backbone is the decoder of "
               "ATTN_FULL/ATTN_LOCAL/RGLRU/RWKV mixers with the dense FFN; "
               "MoE, encoder-decoder and VLM inputs wait for later slices, "
               "ROADMAP queue 1 item 14")


def check_supported(cfg: ModelConfig) -> None:
    for mixer, ffn in cfg.layer_kinds:
        if (mixer not in (ATTN_FULL, ATTN_LOCAL, RGLRU, RWKV)
                or ffn != FFN_DENSE):
            raise NotImplementedError(f"{cfg.name}: ({mixer}, {ffn}) "
                                      + _NOT_PORTED)
    if cfg.is_encoder_decoder or cfg.vision_prefix or cfg.mrope:
        raise NotImplementedError(f"{cfg.name}: " + _NOT_PORTED)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, mixer_kind: str, device=None):
        super().__init__()
        self.mixer_kind = mixer_kind
        self.norm1 = layers.Norm(cfg, cfg.d_model, device=device)
        if mixer_kind == RGLRU:
            self.mixer = rglru.RGLRU(cfg, device=device)
        elif mixer_kind == RWKV:
            self.mixer = rwkv6.RWKV6(cfg, device=device)
        else:
            self.mixer = attention.Attention(cfg, device=device)
        self.norm2 = layers.Norm(cfg, cfg.d_model, device=device)
        self.ffn = layers.MLP(cfg, device=device)

    def forward(self, x, cfg: ModelConfig, *, positions=None, cache=None,
                cache_pos=None):
        h = self.norm1(x)
        if self.mixer_kind == RGLRU:
            out, cache = rglru.apply_rglru_block(self.mixer, h, cfg, cache)
        elif self.mixer_kind == RWKV:
            out, cache = rwkv6.apply_rwkv6_block(self.mixer, h, cfg, cache)
        else:
            out, cache = self.mixer(h, cfg, mixer_kind=self.mixer_kind,
                                    positions=positions, cache=cache,
                                    cache_pos=cache_pos)
        x = x + out
        x = x + self.ffn(self.norm2(x))
        return x, cache


class Backbone(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        dt = layers.cdtype(cfg)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              dtype=dt, device=device))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, mixer, device=device)
            for mixer, _ in cfg.layer_kinds)
        self.final_norm = layers.Norm(cfg, cfg.d_model, device=device)
        self.lm_head = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab_size,
                                                dtype=dt, device=device))
        self.value_head = nn.Parameter(torch.zeros(cfg.d_model, 1,
                                                   dtype=torch.float32,
                                                   device=device))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Backbone:
    """Random weights drawn directly on ``device`` (the generator must
    live there too), one tensor at a time; norms start at scale 1 and
    bias 0 and the value head at 0, as in the reference. The numbers
    differ from the reference's ``jax.random`` ones: tests carry JAX
    weights across with ``bridge.params_from_jax``."""
    model = Backbone(cfg, device=device)
    layers.normal_(model.embed, generator, cfg.d_model ** -0.5)
    for layer in model.layers:
        layer.mixer.init_weights(generator)
        layer.ffn.init_weights(generator)
    layers.normal_(model.lm_head, generator, cfg.d_model ** -0.5)
    return model


def _init_layer_cache(cfg: ModelConfig, mixer_kind: str, batch: int,
                      max_len: int, device=None) -> dict:
    if mixer_kind == RGLRU:
        return rglru.init_rglru_cache(cfg, batch, device=device)
    if mixer_kind == RWKV:
        return rwkv6.init_rwkv6_cache(cfg, batch, device=device)
    return attention.init_cache(
        cfg, batch, max_len, device=device,
        window=cfg.window if mixer_kind == ATTN_LOCAL else 0)


def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device=None) -> list:
    """One dict per layer: ``{"k", "v"}`` for attention, ``{"h", "conv"}``
    for RG-LRU, ``{"state", "xprev"}`` for RWKV-6."""
    return [_init_layer_cache(cfg, mixer, batch, max_len, device=device)
            for mixer, _ in cfg.layer_kinds]


def forward(model: Backbone, cfg: ModelConfig, tokens, *, positions=None,
            cache=None, cache_pos=None):
    """Full sequence (cache None), prefill (cache given, S > 1) or decode
    (cache given, S == 1, cache_pos given). Returns (hidden, cache).

    Each layer's returned cache replaces its entry in the caller's list:
    attention writes its k/v in place and returns the same dict, the
    recurrent mixers return new state."""
    x = layers.apply_embed(model.embed, tokens) * math.sqrt(cfg.d_model)
    x = x.to(layers.cdtype(cfg))
    for i, layer in enumerate(model.layers):
        x, new = layer(x, cfg, positions=positions,
                       cache=None if cache is None else cache[i],
                       cache_pos=cache_pos)
        if cache is not None:
            cache[i] = new
    return model.final_norm(x), cache


def logits_and_value(model: Backbone, cfg: ModelConfig, hidden):
    """(logits (B, S, V) fp32, value (B, S) fp32): the LM head runs in the
    model dtype and is then widened, as in the reference."""
    logits = (hidden @ model.lm_head).float()
    logits = layers.softcap(logits, cfg.final_softcap)
    value = (hidden.float() @ model.value_head)[..., 0]
    return logits, value


def prefill(model: Backbone, cfg: ModelConfig, tokens, max_len: int):
    """Build decode caches from a full prompt. Returns
    (logits_last (B, V), value_last (B,), cache)."""
    B, _ = tokens.shape
    cache = init_decode_cache(cfg, B, max_len, device=tokens.device)
    hidden, cache = forward(model, cfg, tokens, cache=cache)
    logits, value = logits_and_value(model, cfg, hidden[:, -1:])
    return logits[:, 0], value[:, 0], cache


def decode_step(model: Backbone, cfg: ModelConfig, token, cache, pos: int):
    """token: (B, 1) int; pos: position of ``token``. Returns
    (logits (B, V), value (B,), cache), the cache list updated in place."""
    B = token.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.long,
                           device=token.device)
    hidden, cache = forward(model, cfg, token, positions=positions,
                            cache=cache, cache_pos=pos)
    logits, value = logits_and_value(model, cfg, hidden)
    return logits[:, 0], value[:, 0], cache
